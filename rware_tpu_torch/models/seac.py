"""SEAC-PPO: the shared-experience objective on a PPO trust region (the
counterpart of ``build_seac_ppo_train_step`` in ``rware_tpu/models/seac.py``,
MLP, without message bits).

Each agent keeps its OWN actor-critic and learns from every agent's
experience: for agent i on agent j's sample the ratio ``pi_i / pi_j,behaviour``
is the SEAC importance weight, clipped; pair weight 1 on the diagonal and
``seac_lambda`` off it; the entropy bonus on each agent's own policy only.

The parameters are one ``(N, P)`` float32 stack, row i agent i's flat vector
in the :class:`~rware_tpu_torch.models.networks.BlockDims` layout, and the
optimizer is optax's ``chain(clip_by_global_norm, adam(lr, eps=1e-5))`` over
the whole stack (``seac.py:78-81``): one global norm across all agents and a
constant lr, so :class:`~rware_tpu_torch.models.ppo.AdamState` and
:func:`~rware_tpu_torch.models.ppo.clip_adam` serve unchanged.

* :func:`build_seac_ppo_fused_train_step` is the learner on the kernels
  (``collect_mode="pallas", update_mode="fused"``, ``seac.py:482-605``): the
  per-agent collector (K2d), the cross values and GAE, then E x M time-window
  passes of the per-agent gradient kernel (K8), each followed by the optimizer
  step.
* :func:`build_seac_ppo_train_step` is the plain learner (the XLA path,
  ``seac.py:607-728``): the plain version of the per-agent collector, cross
  values in flax's rounding, flat minibatches over ``T * B`` rolled by a
  random offset each epoch, autograd of :func:`seac_ppo_loss`.

The cross arrays (old values, advantages, targets) of the fused learner are
``(N_i, T, B, N_j)``: agent i's critic on agent j's experience, slab i one
``(T, B, N)`` array in the trajectory's own layout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.models.ippo import (
    IPPOConfig,
    RunnerState,
    adam_hyper,
    collect_seed,
    mean_metrics,
    optimizer_init,
    policy_of,
    update_metrics,
)
from rware_tpu_torch.models.networks import (
    BlockDims,
    apply_forward,
    init_actor_critic,
    pack_arrays,
    params_to_arrays,
    train_forward,
)
from rware_tpu_torch.models.ppo import (
    AdamState,
    clip_adam,
    loss_grads,
    seac_loss_native,
    seac_terms,
)
from rware_tpu_torch.ops.fused_rollout import build_fused_collect_per_agent
from rware_tpu_torch.ops.fused_seac import build_fused_seac_grads
from rware_tpu_torch.ops.fused_update import metric_means

CROSS_CHUNK = 1 << 20  # samples per chunk of the cross-value forward

__all__ = [
    "SEACPPOConfig", "SeacTrainStep", "build_seac_ppo_fused_train_step",
    "build_seac_ppo_train_step", "cross_gae", "cross_last_values", "cross_values",
    "init_seac_ppo", "seac_loss_native", "seac_optimizer_step", "seac_policies_of",
    "seac_ppo_loss", "seac_window_starts",
]


@dataclasses.dataclass(frozen=True)
class SEACPPOConfig:
    """Ported copy of ``rware_tpu.models.seac.SEACPPOConfig``."""

    n_envs: int = 1024
    rollout_len: int = 128
    epochs: int = 4
    minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    seac_lambda: float = 1.0
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5


def init_seac_ppo(env: Warehouse, cfg: SEACPPOConfig, seed: int,
                  hidden: Tuple[int, int] = (128, 128)) -> Tuple[RunnerState, BlockDims]:
    """N independent flax-default inits (``seac.py:61-98``), agent i's drawn
    from ``numpy.random.default_rng((seed, 2, i))``, stacked into ``(N, P)``;
    the optimizer state over the stack and a fresh batch of ``cfg.n_envs``
    env states on ``env.device``."""
    from rware_tpu_torch.parallel import batched_reset

    if env.config.msg_bits:
        raise NotImplementedError("SEAC-PPO with message bits is not ported yet")
    l_obs = env.config.flattened_obs_length
    models = [init_actor_critic(l_obs, env.n_actions, hidden, (seed, 2, i))
              for i in range(env.n_agents)]
    params = torch.stack([pack_arrays(params_to_arrays(m)) for m in models])
    params = params.detach().to(env.device)
    env_states, obs = batched_reset(env, seed, cfg.n_envs)
    runner = RunnerState(
        params=params, opt_state=optimizer_init(params), env_states=env_states, obs=obs,
        generator=torch.Generator().manual_seed(seed), update_idx=0, seed=seed,
    )
    return runner, BlockDims.of(models[0])


def seac_optimizer_step(cfg: SEACPPOConfig, params, grads, opt_state: AdamState):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr,
    eps=1e-5))`` over the whole (N, P) stack: one global norm across all
    agents, a constant lr.  Returns (params, opt_state)."""
    hyper = adam_hyper(IPPOConfig(lr=cfg.lr), opt_state.count, 1)[0].to(params.device)
    params, mu, nu = clip_adam(params, grads, opt_state.mu, opt_state.nu, hyper,
                               cfg.max_grad_norm)
    return params, AdamState(opt_state.count + 1, mu, nu)


def seac_policies_of(dims: BlockDims, params: torch.Tensor,
                     models: Optional[nn.ModuleList] = None) -> nn.ModuleList:
    """The N :class:`ActorCritic` holding the rows of ``params`` (copied into
    ``models`` when given) — what the per-agent collector runs."""
    if models is None:
        return nn.ModuleList(policy_of(dims, p) for p in params)
    for p, model in zip(params, models):
        policy_of(dims, p, model.to(p.device))
    return models


def cross_values(dims: BlockDims, params: torch.Tensor, obs: torch.Tensor,
                 forward: Callable = train_forward) -> torch.Tensor:
    """(N_i, T, B, N_j) values of agent i's critic on every stored
    observation (T, B, N_j, L), by ``forward`` (the kernels' rounding,
    ``_native_forward`` at ``seac.py:511-515``, unless flax's is asked for),
    a chunk of time rows at a time."""
    n = params.shape[0]
    t_len, b = obs.shape[:2]
    out = torch.empty((n,) + tuple(obs.shape[:3]), dtype=torch.float32, device=obs.device)
    rows = max(1, CROSS_CHUNK // (b * obs.shape[2]))
    with torch.no_grad():
        for i in range(n):
            arrays = dims.split(params[i])
            for t0 in range(0, t_len, rows):
                out[i, t0:t0 + rows] = forward(arrays, obs[t0:t0 + rows])[1]
    return out


def cross_last_values(dims: BlockDims, params: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """(N_i, B, N_j) bootstrap values of the observations (B, N_j, L) after
    the rollout under each agent's critic, by flax's ``model.apply`` recipe
    (``seac.py:516-521``)."""
    with torch.no_grad():
        return torch.stack([apply_forward(dims.split(p), obs)[1] for p in params])


def cross_gae(cfg, reward: torch.Tensor, values: torch.Tensor, done: torch.Tensor,
              last: torch.Tensor):
    """GAE of agent j's reward stream under agent i's critic
    (``seac.py:523-538``): ``values`` (N_i, T, B, N_j), ``reward`` (T, B, N_j)
    and ``done`` (T, B) broadcast over i, ``last`` (N_i, B, N_j).  Returns
    (advantages, targets), both (N_i, T, B, N_j)."""
    g = torch.zeros_like(last)
    next_v = last
    out = []
    for t in range(reward.shape[0] - 1, -1, -1):
        not_done = 1.0 - done[t].to(torch.float32)[:, None]
        delta = reward[t] + cfg.gamma * next_v * not_done - values[:, t]
        g = delta + cfg.gamma * cfg.gae_lambda * not_done * g
        next_v = values[:, t]
        out.append(g)
    advantages = torch.stack(out[::-1], dim=1)
    return advantages, advantages + values


def seac_window_starts(cfg: SEACPPOConfig, offsets) -> torch.Tensor:
    """(E * M,) int64 window starts: epoch e's pass m reads rows from
    ``(m * t_mb - offsets[e]) % T`` on (``seac.py:562-581``; the offsets are
    time rows in [0, T), not time blocks)."""
    t_len, m = cfg.rollout_len, cfg.minibatches
    offs = torch.as_tensor(offsets, dtype=torch.int64).reshape(-1, 1)
    return ((torch.arange(m)[None, :] * (t_len // m) - offs) % t_len).reshape(-1)


def seac_ppo_loss(cfg: SEACPPOConfig, dims: BlockDims, params: torch.Tensor, batch):
    """The plain learner's minibatch loss in flax's rounding
    (``minibatch_loss``, ``seac.py:443-480``; each agent's network is
    :func:`apply_forward`) on a flat minibatch ``(obs (M, N_j, L), action,
    behaviour logp (M, N_j), old_value, adv, target (M, N_i, N_j))``; the
    advantages normalised over the minibatch.  Returns (total, metrics)."""
    obs, action, behav_logp, old_value, adv, target = batch
    heads = [apply_forward(dims.split(params[i]), obs) for i in range(params.shape[0])]
    logits = torch.stack([h[0] for h in heads], dim=1)  # (M, N_i, N_j, A)
    value = torch.stack([h[1] for h in heads], dim=1)
    return seac_terms(cfg, cfg.seac_lambda, logits, value, action[:, None], behav_logp[:, None],
                      old_value, adv, target, 1)


class SeacTrainStep:
    """``train_step(runner, offsets=None) -> (runner, metrics)``; see
    :func:`build_seac_ppo_fused_train_step`.  The phases are methods so that
    callers can time them: :meth:`rollout`, :meth:`advantages`,
    :meth:`update`."""

    def __init__(self, env: Warehouse, dims: BlockDims, cfg: SEACPPOConfig,
                 deterministic_collect: bool = False):
        if cfg.rollout_len % cfg.minibatches:
            raise ValueError(f"minibatches={cfg.minibatches} must divide "
                             f"rollout_len={cfg.rollout_len} (time-window minibatches)")
        self.env, self.dims, self.cfg = env, dims, cfg
        self.collect = build_fused_collect_per_agent(env.config, cfg.rollout_len,
                                                     (dims.h1, dims.h2),
                                                     deterministic=deterministic_collect)
        self.grads = build_fused_seac_grads(dims, env.n_agents, cfg.rollout_len // cfg.minibatches,
                                            cfg.clip_eps, cfg.vf_coef, cfg.ent_coef,
                                            cfg.seac_lambda)
        self._policies = None

    def rollout(self, runner: RunnerState):
        """(env_states, traj) of one per-agent collector launch with this
        update's key."""
        self._policies = seac_policies_of(self.dims, runner.params, self._policies)
        seed = collect_seed(runner.seed, runner.update_idx)
        return self.collect(runner.env_states, self._policies, seed)

    def advantages(self, runner: RunnerState, env_states, traj):
        """(obs after the rollout, cross values, advantages, targets), the
        cross arrays (N_i, T, B, N_j)."""
        obs = self.env._obs_fn(env_states)
        values = cross_values(self.dims, runner.params, traj["obs"])
        last = cross_last_values(self.dims, runner.params, obs)
        adv, targets = cross_gae(self.cfg, traj["reward"], values, traj["done"], last)
        return obs, values, adv, targets

    def update(self, runner: RunnerState, dataset, offsets: Optional[Sequence[int]] = None):
        """((params, opt_state), metrics) of the E x M passes: one K8 launch
        and one optimizer step each."""
        cfg = self.cfg
        if offsets is None:
            offsets = torch.randint(0, cfg.rollout_len, (cfg.epochs,), generator=runner.generator)
        params, opt_state = runner.params, runner.opt_state
        n = self.grads.t_mb * dataset[1].shape[1] * dataset[1].shape[2]
        per_pass = []
        for start in seac_window_starts(cfg, offsets).tolist():
            grads, sums = self.grads(params, dataset, start)
            params, opt_state = seac_optimizer_step(cfg, params, grads, opt_state)
            per_pass.append(metric_means(sums, n))
        return (params, opt_state), mean_metrics(per_pass)

    def __call__(self, runner: RunnerState, offsets: Optional[Sequence[int]] = None
                 ) -> Tuple[RunnerState, dict]:
        env_states, traj = self.rollout(runner)
        obs, values, adv, targets = self.advantages(runner, env_states, traj)
        dataset = (traj["obs"], traj["action"], traj["logp"], values, adv, targets)
        (params, opt_state), ppo = self.update(runner, dataset, offsets)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, ppo)


def build_seac_ppo_fused_train_step(env: Warehouse, dims: BlockDims, cfg: SEACPPOConfig,
                                    deterministic_collect: bool = False) -> SeacTrainStep:
    """The SEAC-PPO learner on the kernels (``build_seac_ppo_train_step`` with
    ``collect_mode="pallas", update_mode="fused"``): K2d collect with each
    agent's own network, cross values in the kernels' rounding, bootstrap
    values in flax's, cross GAE, then per epoch one offset in [0, T) and M
    time windows ``(m * t_mb - off) % T`` read in place, each one K8 launch
    for all agents and one clip + Adam step over the stack.  ``offsets`` of a
    call overrides the (E,) offsets drawn from the runner's generator.  On a
    CUDA runner every kernel runs on the card; on a CPU runner every wrapper
    runs its plain version."""
    return SeacTrainStep(env, dims, cfg, deterministic_collect)


def build_seac_ppo_train_step(env: Warehouse, dims: BlockDims, cfg: SEACPPOConfig
                              ) -> Callable[[RunnerState], Tuple[RunnerState, dict]]:
    """The plain SEAC-PPO learner: ``train_step(runner) -> (runner,
    metrics)``.  Collects with the plain version of the per-agent collector
    (Philox draws keyed by :func:`collect_seed`), takes cross values and
    bootstrap values in flax's rounding, cross GAE, then E epochs of M flat
    minibatches over the ``T * B`` rows rolled by a random offset, each
    autograd of :func:`seac_ppo_loss` and one optimizer step."""
    collect = build_fused_collect_per_agent(env.config, cfg.rollout_len, (dims.h1, dims.h2))
    box = [None]
    d = cfg.rollout_len * cfg.n_envs
    mb = d // cfg.minibatches

    def flat(x):  # (T, B, ...) -> (T * B, ...)
        return x.reshape((d,) + x.shape[2:])

    def cross_flat(x):  # (N_i, T, B, N_j) -> (T * B, N_i, N_j)
        return flat(x.permute(1, 2, 0, 3))

    def train_step(runner: RunnerState):
        box[0] = seac_policies_of(dims, runner.params, box[0])
        seed = collect_seed(runner.seed, runner.update_idx)
        env_states, traj = collect.plain(runner.env_states, box[0], seed)
        obs = env._obs_fn(env_states)
        values = cross_values(dims, runner.params, traj["obs"].float(), apply_forward)
        last = cross_last_values(dims, runner.params, obs)
        adv, targets = cross_gae(cfg, traj["reward"], values, traj["done"], last)
        dataset = (flat(traj["obs"].float()), flat(traj["action"]), flat(traj["logp"]),
                   cross_flat(values), cross_flat(adv), cross_flat(targets))
        params, opt_state = runner.params, runner.opt_state
        per_pass = []
        for _ in range(cfg.epochs):
            off = int(torch.randint(0, d, (), generator=runner.generator))
            rolled = tuple(torch.roll(x, off, dims=0) for x in dataset)
            for m in range(cfg.minibatches):
                batch = tuple(x[m * mb:(m + 1) * mb] for x in rolled)
                grads, metrics = loss_grads(lambda p: seac_ppo_loss(cfg, dims, p, batch), params)
                params, opt_state = seac_optimizer_step(cfg, params, grads, opt_state)
                per_pass.append(metrics)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(cfg, traj, mean_metrics(per_pass))

    return train_step
