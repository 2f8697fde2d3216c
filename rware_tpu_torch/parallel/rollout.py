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

from rware_tpu_torch.core.engine import build_policy_obs_fn, build_transition_fn, n_reset_draws
from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.models.networks import bernoulli_logp, sample_action, sample_bernoulli
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


class ScanCollect:
    """``collect(states, params, seed, carry=None, env_offset=0,
    actions=None)``; see :func:`build_scan_collect`."""

    def __init__(self, env: Warehouse, n_steps: int, forward: Callable):
        self.env, self.n_steps, self.forward = env, n_steps, forward
        self.policy_obs = build_policy_obs_fn(env.config, env._obs_fn)
        self.n_goals, self.n_reset = env.layout.n_goals, n_reset_draws(env.config)

    def _sample(self, seed, envs, t, heads):
        """(the engine's actions, move, bits or None, joint logp) drawn from
        this step's Philox uniforms, as the collectors draw them."""
        n, m = self.env.n_agents, self.env.config.msg_bits
        logits, msg_logits = heads if m else (heads, None)
        u = philox.gumbel_uniform(philox.uniform_bits(seed, envs, t, philox.ACTION, n * 5))
        move, logp = sample_action(logits, u.reshape(-1, n, 5))
        if not m:
            return move, move, None, logp
        um = philox.gumbel_uniform(philox.uniform_bits(seed, envs, t, philox.MESSAGE, n * m))
        bits, logp_bits = sample_bernoulli(msg_logits, um.reshape(-1, n, m))
        return torch.cat([move[..., None], bits], dim=-1), move, bits, logp + logp_bits

    def _given(self, actions, heads):
        """(the engine's actions, move, bits or None, joint logp) of given
        actions: their log-probability under ``heads``."""
        m = self.env.config.msg_bits
        logits, msg_logits = heads if m else (heads, None)
        move = actions[..., 0] if m else actions
        logp = torch.log_softmax(logits, -1).gather(-1, move.long()[..., None])[..., 0]
        if not m:
            return actions, move, None, logp
        bits = actions[..., 1:]
        return actions, move, bits, logp + bernoulli_logp(msg_logits, bits).sum(-1)

    @torch.no_grad()
    def __call__(self, states: WarehouseState, params, seed: int, carry=None,
                 env_offset: int = 0, actions: Optional[torch.Tensor] = None):
        envs = philox.env_ids(states.batch_size, env_offset, states.device)
        transition, reset_fn = self.env._transition, self.env._reset_fn
        keys = ("obs", "action", "logp", "reward", "done") \
            + (("bits",) if self.env.config.msg_bits else ())
        out = {k: [] for k in keys}
        obs = self.policy_obs(states)
        for t in range(self.n_steps):
            heads, new_carry = self.forward(params, obs, carry)
            if actions is None:
                acts, move, bits, logp = self._sample(seed, envs, t, heads)
            else:
                acts, move, bits, logp = self._given(actions[t], heads)
            qbits = philox.uniform_bits(seed, envs, t, philox.QUEUE, self.n_goals)
            states, reward, done, _ = transition(states, acts, qbits)
            rbits = philox.uniform_bits(seed, envs, t, philox.RESPAWN, self.n_reset)
            states = autoreset_select(reset_fn, states, done, rbits)
            if carry is not None:  # a new episode starts from the zero carry
                carry = torch.where(done[:, None, None], torch.zeros_like(new_carry), new_carry)
            for k, v in zip(keys, (obs.to(torch.bfloat16), move.to(torch.int32), logp, reward,
                                   done, bits)):
                out[k].append(v)
            obs = self.policy_obs(states)
        traj = {k: torch.stack(v) for k, v in out.items()}
        return (states, traj) if carry is None else (states, carry, traj)


def build_scan_collect(env: Warehouse, n_steps: int, forward: Callable) -> ScanCollect:
    """The plain collect of the learners' ``collect_mode="xla"`` in the JAX
    package (the ``collect`` closures of ``build_mappo_train_step``,
    ``mappo.py:289-346``, and ``build_seac_gru_train_step``,
    ``seac.py:939-960``; a vmap + scan there, a loop over the T steps here):
    ``collect(states, params, seed, carry=None, env_offset=0, actions=None)
    -> (states, traj)``, with a carry ``(states, carry, traj)``.

    Each step observes (``config.policy_obs_length`` features), runs
    ``forward(params, obs (B, N, L), carry) -> (heads, new carry)`` (heads
    the logits, ``(logits, msg_logits)`` with message bits), samples the
    move by Gumbel-argmax and the message bits by Bernoulli
    (``networks.sample_action``, ``sample_bernoulli``), steps the engine and
    resets the envs whose episode ended (:func:`autoreset_select`), zeroing
    their carry.  Every draw comes from Philox keyed by ``seed`` and the
    global env index ``env_offset + i`` (purposes ACTION, MESSAGE, QUEUE and
    RESPAWN, as the fused collectors draw), so a shard's collect is its rows
    of the global one.  ``actions`` (T, B, N), or (T, B, N, 1 + M) with
    message bits, replaces the sampling: the trajectory of given actions
    with their log-probability under the policy.

    ``traj`` is the common ``(T, B, N, ...)`` layout: ``obs`` bf16,
    ``action`` (the move) int32, ``logp`` (the joint log-probability),
    ``reward``, ``done`` (T, B) bool, and with message bits ``bits`` (T, B,
    N, M) int32.  No kernel runs: on any device it is torch ops."""
    return ScanCollect(env, n_steps, forward)
