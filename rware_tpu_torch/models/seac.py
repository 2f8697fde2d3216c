"""SEAC: the shared-experience actor-critic (the counterpart of
``build_seac_train_step``, ``build_seac_ppo_train_step`` and
``build_seac_gru_train_step`` in ``rware_tpu/models/seac.py``): A2C with MLP
policies, and the objective on a PPO trust region with MLP or GRU policies,
each with or without message bits.

Each agent keeps its OWN actor-critic and learns from every agent's
experience: for agent i on agent j's sample the ratio ``pi_i / pi_j,behaviour``
is the SEAC importance weight, clipped; pair weight 1 on the diagonal and
``seac_lambda`` off it; the entropy bonus on each agent's own policy only.
With message bits (``msg_bits`` M > 0) every log-probability, ratio and
entropy is the joint one over (move, bits) (``seac.py:415-441, 961-984``).

The parameters are one ``(N, P)`` float32 stack, row i agent i's flat vector
in the :class:`~rware_tpu_torch.models.networks.BlockDims` (MLP) or
:class:`~rware_tpu_torch.models.networks.GruDims` (GRU) layout, and the
optimizer is optax's ``chain(clip_by_global_norm, adam(lr, eps=1e-5))`` over
the whole stack (``seac.py:78-81``): one global norm across all agents and a
constant lr, so :class:`~rware_tpu_torch.models.ppo.AdamState` and
:func:`~rware_tpu_torch.models.ppo.clip_adam` serve unchanged.

* :func:`build_seac_train_step` is SEAC A2C (``seac.py:101-276``, the
  algorithm of Christianos et al., NeurIPS 2020): short rollouts (T=5 by
  default) of the per-agent collector (K2d, with its message mode K2b), then
  one autograd of :func:`seac_a2c_loss` (cross forwards in flax's rounding,
  cross GAE, the unclipped importance-weighted terms without advantage
  normalisation) and one optimizer step.
* :func:`build_seac_ppo_fused_train_step` is the MLP learner on the kernels
  (``collect_mode="pallas", update_mode="fused"``, ``seac.py:482-605``): the
  per-agent collector (K2d), the cross values and GAE, then E x M time-window
  passes of the per-agent gradient kernel (K8), each followed by the optimizer
  step.  K8 has no message head, so it takes no message bits, as JAX's does
  not (``seac.py:359-363``).
* :func:`build_seac_ppo_train_step` is the flat learner (the XLA update,
  ``seac.py:607-728``): the per-agent collector (K2d, with its message mode
  K2b) or its plain version, cross values in flax's rounding, flat
  minibatches over ``T * B`` rolled by a random offset each epoch, autograd
  of :func:`seac_ppo_loss`.  JAX runs SEAC-PPO with message bits this way
  (``update_mode="auto"`` picks it, ``seac.py:343-345``).
* :func:`build_seac_gru_train_step` is the recurrent learner
  (``seac.py:846-1173``): the per-agent recurrent collector (K2d′), the cross
  replay of every agent's GRU over every agent's observation stream
  (:func:`gru_cross_replay`) for the old values and the bootstrap, cross GAE,
  then E x M env-band minibatches, each autograd of :func:`seac_gru_loss`;
  with ``collect="plain"`` JAX's ``collect_mode="xla"`` (``train --collect
  plain``): the plain collect with each agent's GRU in the flax module's
  rounding in place of K2d′, no kernel on any device.
  With a :class:`~rware_tpu_torch.parallel.sharding.Mesh` it is data parallel
  (``seac.py:855``): K2d′ collects this rank's rows keyed by their global
  indices, the cross replay and GAE run on them, the env bands are the
  shard's, and each band's gradients and metrics leave as their mean over the
  ranks before the one clip + Adam step over the stack.

The other three learners JAX builds without a mesh and only places on one
(``seac.py:101, 310``; ``train.py:291-303``), so under a mesh they keep their
one-device meaning: each rank collects its rows of the global batch at their
global indices, every pass's advantage statistics are its whole minibatch's
(one float64 all-reduce of every pass's moments and the reward sums before
the first pass), and each pass's gradients and metrics leave in one packed
all-reduce: the mean of the ranks' equal time windows for K8, the sum of the
ranks' partial sums over the global count for the flat minibatches, and for
A2C, whose loss has no statistic, the mean of the ranks' equal rollouts.

The cross arrays (old values, advantages, targets) of the A2C and
time-window learners are ``(N_i, T, B, N_j)``: agent i's critic on agent j's
experience, slab i one ``(T, B, N)`` array in the trajectory's own layout.  The recurrent learner's
are ``(T, B, N_i, N_j)``, JAX's layout, so that an env band is one slice of
axis 1 of every array.
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
    policy_obs_fn,
    policy_of,
    reset_envs,
    reward_sums,
    update_metrics,
)
from rware_tpu_torch.models.ippo_rnn import RNNRunnerState, band_slice, rnn_policy_of
from rware_tpu_torch.models.networks import (
    DENSE_CAST_BLOCKS,
    BlockDims,
    GruDims,
    apply_forward,
    gru_apply_step,
    gru_to_arrays,
    init_actor_critic,
    init_recurrent_actor_critic,
    pack_arrays,
    params_to_arrays,
    round_grad_blocks,
    split_heads,
    train_forward,
)
from rware_tpu_torch.models.ppo import (
    AdamState,
    clip_adam,
    cross_logp,
    loss_grads,
    seac_loss_native,
    seac_terms,
)
from rware_tpu_torch.ops.fused_rollout import (
    build_fused_collect_gru_per_agent,
    build_fused_collect_per_agent,
)
from rware_tpu_torch.ops.fused_seac import build_fused_seac_grads
from rware_tpu_torch.ops.fused_update import metric_means, window_rows
from rware_tpu_torch.parallel.rollout import ScanCollect, build_scan_collect
from rware_tpu_torch.parallel.sharding import (
    Mesh,
    data_parallel,
    rank_rows,
    row_moments,
    whole_batch_stats,
)

CROSS_CHUNK = 1 << 20  # samples per chunk of the cross-value forward

__all__ = [
    "SEACConfig", "SEACPPOConfig", "SeacA2CTrainStep", "SeacFlatTrainStep", "SeacGruTrainStep",
    "SeacTrainStep", "build_seac_gru_train_step", "build_seac_ppo_fused_train_step",
    "build_seac_ppo_train_step", "build_seac_train_step", "cross_gae", "cross_last_values",
    "cross_values", "gru_cross_replay", "init_seac", "init_seac_gru", "init_seac_ppo",
    "seac_a2c_loss", "seac_gru_loss", "seac_gru_policies_of", "seac_loss_native",
    "seac_optimizer_step", "seac_policies_of", "seac_ppo_loss", "seac_window_starts",
]


@dataclasses.dataclass(frozen=True)
class SEACConfig:
    """Ported copy of ``rware_tpu.models.seac.SEACConfig``: short n-step
    rollouts, as in the paper."""

    n_envs: int = 256
    rollout_len: int = 5
    gamma: float = 0.99
    gae_lambda: float = 0.95
    seac_lambda: float = 1.0  # weight of the shared-experience terms
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5


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


def init_seac(env: Warehouse, cfg: SEACConfig, seed: int,
              hidden: Tuple[int, int] = (128, 128), mesh: Optional[Mesh] = None
              ) -> Tuple[RunnerState, BlockDims]:
    """N independent flax-default inits (``seac.py:61-98``), agent i's drawn
    from ``numpy.random.default_rng((seed, 2, i))`` (with a message head where
    the config has message bits), stacked into ``(N, P)``; the optimizer
    state over the stack and a fresh batch of ``cfg.n_envs`` env states on
    ``env.device`` (with a mesh this rank's rows, keyed by their global
    indices)."""
    l_obs = env.config.policy_obs_length
    models = [init_actor_critic(l_obs, env.n_actions, hidden, (seed, 2, i), env.config.msg_bits)
              for i in range(env.n_agents)]
    params = torch.stack([pack_arrays(params_to_arrays(m)) for m in models])
    params = params.detach().to(env.device)
    env_states = reset_envs(env, seed, cfg.n_envs, mesh)
    obs = policy_obs_fn(env)(env_states)
    runner = RunnerState(
        params=params, opt_state=optimizer_init(params), env_states=env_states, obs=obs,
        generator=torch.Generator().manual_seed(seed), update_idx=0, seed=seed,
    )
    return runner, BlockDims.of(models[0])


def init_seac_ppo(env: Warehouse, cfg: SEACPPOConfig, seed: int,
                  hidden: Tuple[int, int] = (128, 128), mesh: Optional[Mesh] = None
                  ) -> Tuple[RunnerState, BlockDims]:
    """The runner of :func:`init_seac` for the batch of ``cfg``
    (``seac.py:296-307``)."""
    return init_seac(env, SEACConfig(n_envs=cfg.n_envs, rollout_len=cfg.rollout_len, lr=cfg.lr,
                                     max_grad_norm=cfg.max_grad_norm), seed, hidden, mesh)


def seac_optimizer_step(cfg, params, grads, opt_state: AdamState):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr,
    eps=1e-5))`` over the whole (N, P) stack: one global norm across all
    agents, a constant lr (``cfg`` a :class:`SEACConfig` or
    :class:`SEACPPOConfig`).  Returns (params, opt_state)."""
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
                out[i, t0:t0 + rows] = forward(arrays, obs[t0:t0 + rows], dims.msg_bits)[1]
    return out


def cross_last_values(dims: BlockDims, params: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """(N_i, B, N_j) bootstrap values of the observations (B, N_j, L) after
    the rollout under each agent's critic, by flax's ``model.apply`` recipe
    (``seac.py:516-521``)."""
    with torch.no_grad():
        return torch.stack([apply_forward(dims.split(p), obs, dims.msg_bits)[1] for p in params])


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


def seac_ppo_loss(cfg: SEACPPOConfig, dims: BlockDims, params: torch.Tensor, batch,
                  advstats: Optional[torch.Tensor] = None, count: Optional[torch.Tensor] = None):
    """The flat learner's minibatch loss in flax's rounding
    (``minibatch_loss``, ``seac.py:443-480``; each agent's network is
    :func:`apply_forward`) on a flat minibatch ``(obs (M, N_j, L), action,
    behaviour logp (M, N_j), old_value, adv, target (M, N_i, N_j))``, and the
    bits (M, N_j, M_bits) as a 7th entry where ``dims`` has message bits
    (the joint log-prob and entropy of ``cross_logp``, ``seac.py:415-441``);
    the advantages normalised over the minibatch; ``advstats`` and ``count``
    as in :func:`~rware_tpu_torch.models.ppo.seac_terms` (a rank's part of a
    whole minibatch).  The hidden weights' and biases' gradients are float32
    sums: the learner rounds the whole batch's to bf16 (JAX's cast,
    :func:`~rware_tpu_torch.models.networks.round_grad_blocks`).  Returns
    (total, metrics)."""
    obs, action, behav_logp, old_value, adv, target = batch[:6]
    heads = [apply_forward(dims.split(params[i]), obs, dims.msg_bits)
             for i in range(params.shape[0])]
    value = torch.stack([h[1] for h in heads], dim=1)  # (M, N_i, N_j)
    if dims.msg_bits:
        logits = (torch.stack([h[0][0] for h in heads], dim=1),
                  torch.stack([h[0][1] for h in heads], dim=1))
    else:
        logits = torch.stack([h[0] for h in heads], dim=1)  # (M, N_i, N_j, A)
    bits = batch[6][:, None] if dims.msg_bits else None
    return seac_terms(cfg, cfg.seac_lambda, logits, value, action[:, None], behav_logp[:, None],
                      old_value, adv, target, 1, advstats, bits, count)


class SeacTrainStep:
    """``train_step(runner, offsets=None) -> (runner, metrics)``; see
    :func:`build_seac_ppo_fused_train_step`.  The phases are methods so that
    callers can time them: :meth:`rollout`, :meth:`advantages`,
    :meth:`update`."""

    def __init__(self, env: Warehouse, dims: BlockDims, cfg: SEACPPOConfig,
                 deterministic_collect: bool = False, mesh: Optional[Mesh] = None):
        if cfg.rollout_len % cfg.minibatches:
            raise ValueError(f"minibatches={cfg.minibatches} must divide "
                             f"rollout_len={cfg.rollout_len} (time-window minibatches)")
        self.env_offset = 0 if mesh is None else mesh.env_offset(cfg.n_envs)
        self.env, self.dims, self.cfg, self.mesh = env, dims, cfg, mesh
        self.policy_obs = policy_obs_fn(env)
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
        return self.collect(runner.env_states, self._policies, seed, self.env_offset)

    def advantages(self, runner: RunnerState, env_states, traj):
        """(obs after the rollout, cross values, advantages, targets), the
        cross arrays (N_i, T, B, N_j)."""
        obs = self.policy_obs(env_states)
        values = cross_values(self.dims, runner.params, traj["obs"])
        last = cross_last_values(self.dims, runner.params, obs)
        adv, targets = cross_gae(self.cfg, traj["reward"], values, traj["done"], last)
        return obs, values, adv, targets

    def update(self, runner: RunnerState, dataset, offsets: Optional[Sequence[int]] = None,
               sums=()):
        """((params, opt_state), metrics, sums) of the E x M passes: every
        window's advantage statistics over all its pairs and the whole
        batch's envs and the tensors of ``sums`` (this rank's reward sums)
        in one float64 all-reduce, then per window one K8 launch with those
        statistics (with a mesh its gradients and metrics averaged over the
        ranks' equal windows) and one optimizer step; ``sums`` returns
        summed over the ranks."""
        cfg, mesh = self.cfg, self.mesh
        if offsets is None:
            offsets = torch.randint(0, cfg.rollout_len, (cfg.epochs,), generator=runner.generator)
        starts = seac_window_starts(cfg, offsets).tolist()
        windows = [window_rows(start, self.grads.t_mb, cfg.rollout_len, "cpu")
                   for start in starts]
        advstats, _, sums = whole_batch_stats(row_moments(dataset[4], 1), windows, sums, mesh)
        n = self.grads.t_mb * dataset[1].shape[1] * dataset[1].shape[2]

        def window_grads(params, start, stats):
            grads, metric_sums = self.grads(params, dataset, start, stats)
            return grads, metric_means(metric_sums, n)

        grads_fn = data_parallel(window_grads, mesh)
        params, opt_state = runner.params, runner.opt_state
        per_pass = []
        for start, stats in zip(starts, advstats):
            grads, metrics = grads_fn(params, start, stats)
            params, opt_state = seac_optimizer_step(cfg, params, grads, opt_state)
            per_pass.append(metrics)
        return (params, opt_state), mean_metrics(per_pass), sums

    def __call__(self, runner: RunnerState, offsets: Optional[Sequence[int]] = None
                 ) -> Tuple[RunnerState, dict]:
        env_states, traj = self.rollout(runner)
        obs, values, adv, targets = self.advantages(runner, env_states, traj)
        dataset = (traj["obs"], traj["action"], traj["logp"], values, adv, targets)
        (params, opt_state), ppo, sums = self.update(runner, dataset, offsets,
                                                  reward_sums(traj))
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, ppo, sums=sums)


def build_seac_ppo_fused_train_step(env: Warehouse, dims: BlockDims, cfg: SEACPPOConfig,
                                    deterministic_collect: bool = False,
                                    mesh: Optional[Mesh] = None) -> SeacTrainStep:
    """The SEAC-PPO learner on the kernels (``build_seac_ppo_train_step`` with
    ``collect_mode="pallas", update_mode="fused"``): K2d collect with each
    agent's own network, cross values in the kernels' rounding, bootstrap
    values in flax's, cross GAE, then per epoch one offset in [0, T) and M
    time windows ``(m * t_mb - off) % T`` read in place, each one K8 launch
    for all agents and one clip + Adam step over the stack.  ``offsets`` of a
    call overrides the (E,) offsets drawn from the runner's generator.  Each
    window's advantages are normalised over the window's pairs and envs.
    ``mesh`` makes it data parallel with the whole batch's statistics (the
    module's head): the runner holds this rank's envs and ``cfg.n_envs`` is
    the global batch.  On a CUDA runner every kernel runs on the card; on a
    CPU runner every wrapper runs its plain version."""
    return SeacTrainStep(env, dims, cfg, deterministic_collect, mesh)


class _PerAgentRollout:
    """The MLP learners' collection by autoreset rollouts of the per-agent
    collector: through its kernel (K2d, and K2b with message bits) on a CUDA
    runner with ``collect="fused"``, its plain version on a CPU runner or with
    ``collect="plain"``."""

    def __init__(self, env: Warehouse, dims: BlockDims, cfg, collect: str,
                 deterministic_collect: bool = False, mesh: Optional[Mesh] = None):
        if collect not in ("fused", "plain"):
            raise ValueError(f"collect must be 'fused' or 'plain', got {collect!r}")
        self.env_offset = 0 if mesh is None else mesh.env_offset(cfg.n_envs)
        self.env, self.dims, self.cfg, self.mesh = env, dims, cfg, mesh
        self.policy_obs = policy_obs_fn(env)
        self.collect = build_fused_collect_per_agent(env.config, cfg.rollout_len,
                                                     (dims.h1, dims.h2),
                                                     deterministic=deterministic_collect)
        self.plain_collect = collect == "plain"
        self._policies = None

    def rollout(self, runner: RunnerState):
        """(env_states, traj) of the per-agent collector (or its plain
        version) with this update's key, on this rank's envs at their global
        indices."""
        self._policies = seac_policies_of(self.dims, runner.params, self._policies)
        seed = collect_seed(runner.seed, runner.update_idx)
        collect = self.collect.plain if self.plain_collect else self.collect
        return collect(runner.env_states, self._policies, seed, self.env_offset)


class SeacFlatTrainStep(_PerAgentRollout):
    """``train_step(runner, offsets=None) -> (runner, metrics)``; see
    :func:`build_seac_ppo_train_step`.  The phases are methods so that
    callers can time them: :meth:`rollout`, :meth:`advantages`,
    :meth:`update`."""

    def advantages(self, runner: RunnerState, env_states, traj):
        """(obs after the rollout, cross values, advantages, targets), the
        cross arrays (N_i, T, B, N_j), values and bootstrap in flax's
        rounding (``seac.py:650-675``)."""
        obs = self.policy_obs(env_states)
        values = cross_values(self.dims, runner.params, traj["obs"], apply_forward)
        last = cross_last_values(self.dims, runner.params, obs)
        adv, targets = cross_gae(self.cfg, traj["reward"], values, traj["done"], last)
        return obs, values, adv, targets

    def update(self, runner: RunnerState, dataset, offsets: Optional[Sequence[int]] = None,
               sums=()):
        """((params, opt_state), metrics, sums) of the E x M flat minibatches
        over the whole batch's ``T * B`` rows (``dataset``: obs, action,
        logp (T, B, N, ...), the cross arrays (N_i, T, B, N_j), and the bits
        with message bits; this rank's envs): epoch e rolls the
        rows by ``offsets[e]`` in [0, T * B) (drawn from the runner's
        generator if None, the same on every rank), then each minibatch is
        this rank's rows of it, one autograd of :func:`seac_ppo_loss` (its
        advantages normalised over the whole minibatch, a partial sum over
        its count; with a mesh its gradients and metrics summed over the
        ranks) and one optimizer step.  Every minibatch's statistics and the
        tensors of ``sums`` (this rank's reward sums) leave in one float64
        all-reduce first; ``sums`` returns summed over the ranks."""
        cfg, dims, mesh = self.cfg, self.dims, self.mesh
        d = cfg.rollout_len * cfg.n_envs
        mb = d // cfg.minibatches
        if offsets is None:
            offsets = torch.randint(0, d, (cfg.epochs,), generator=runner.generator)

        def flat(x):  # (T, B, ...) -> (T * B, ...)
            return x.reshape((-1,) + x.shape[2:])

        obs, action, logp, values, adv, targets = dataset[:6]
        # the cross arrays (N_i, T, B, N_j) -> (T * B, N_i, N_j)
        rows = (flat(obs), flat(action), flat(logp),
                *(flat(x.permute(1, 2, 0, 3)) for x in (values, adv, targets)),
                *(flat(x) for x in dataset[6:]))
        # roll(x, off)[m * mb:(m + 1) * mb]: global rows (m * mb - off + k) % d
        passes = [rank_rows((torch.arange(mb) + m * mb - int(off)) % d, cfg.n_envs, mesh)
                  for off in torch.as_tensor(offsets).tolist() for m in range(cfg.minibatches)]
        advstats, counts, sums = whole_batch_stats(row_moments(rows[4]), passes, sums, mesh)
        grads_fn = data_parallel(
            lambda p, batch, stats, n: loss_grads(
                lambda q: seac_ppo_loss(cfg, dims, q, batch, stats, n), p),
            mesh, "sum")
        params, opt_state = runner.params, runner.opt_state
        per_pass = []
        for idx, stats, n in zip(passes, advstats, counts):
            idx = idx.to(params.device)
            grads, metrics = grads_fn(params, tuple(x[idx] for x in rows), stats, n)
            grads = round_grad_blocks(dims, grads, DENSE_CAST_BLOCKS)  # the whole sum's
            params, opt_state = seac_optimizer_step(cfg, params, grads, opt_state)
            per_pass.append(metrics)
        return (params, opt_state), mean_metrics(per_pass), sums

    def __call__(self, runner: RunnerState, offsets: Optional[Sequence[int]] = None
                 ) -> Tuple[RunnerState, dict]:
        env_states, traj = self.rollout(runner)
        obs, values, adv, targets = self.advantages(runner, env_states, traj)
        dataset = (traj["obs"], traj["action"], traj["logp"], values, adv, targets)
        if self.dims.msg_bits:
            dataset += (traj["bits"],)
        (params, opt_state), ppo, sums = self.update(runner, dataset, offsets,
                                                  reward_sums(traj))
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, ppo, sums=sums)


def build_seac_ppo_train_step(env: Warehouse, dims: BlockDims, cfg: SEACPPOConfig,
                              collect: str = "fused", deterministic_collect: bool = False,
                              mesh: Optional[Mesh] = None) -> SeacFlatTrainStep:
    """The flat SEAC-PPO learner (``build_seac_ppo_train_step`` with
    ``update_mode="xla"``): ``train_step(runner, offsets=None) -> (runner,
    metrics)``.  Collects with the per-agent collector, by default through
    its kernel (K2d, and K2b with message bits, on a CUDA runner:
    ``collect_mode="pallas"``; its plain version on a CPU runner), or with
    ``collect="plain"`` through its plain version on any runner (the plain
    learner of ``train --collect plain``; Philox draws keyed by
    :func:`collect_seed`), takes cross values and bootstrap values in flax's
    rounding, cross GAE, then E epochs of M flat minibatches over the ``T *
    B`` rows rolled by an offset in [0, T * B) per epoch, each autograd of
    :func:`seac_ppo_loss` and one optimizer step.  ``offsets`` of a call
    overrides the (E,) offsets drawn from the runner's generator.  The
    learner SEAC-PPO with message bits trains on, since K8 has no message
    head.  ``mesh`` makes it data parallel with the whole batch's statistics
    (the module's head): the runner holds this rank's envs and
    ``cfg.n_envs`` is the global batch."""
    return SeacFlatTrainStep(env, dims, cfg, collect, deterministic_collect, mesh)


# ---------------------------------------------------------------------------
# SEAC A2C (``seac.py:101-276``): every agent's network on every agent's
# experience, one unclipped importance-weighted update per short rollout.
# ---------------------------------------------------------------------------


def seac_a2c_loss(cfg: SEACConfig, dims: BlockDims, params: torch.Tensor, traj: dict,
                  last_obs: torch.Tensor):
    """SEAC A2C's loss (``loss_fn``, ``seac.py:170-231``) on a rollout
    ``traj`` (obs (T, B, N, L), action, behaviour logp, reward (T, B, N), done
    (T, B), and the bits (T, B, N, M) where ``dims`` has message bits) and
    the observations after it ``last_obs`` (B, N, L), for ``params`` (N, P):

    * agent i's network on every agent j's observations, with gradients, in
      flax's rounding (:func:`apply_forward`): heads and values (N_i, T, B,
      N_j);
    * bootstrap values by :func:`cross_last_values`, then :func:`cross_gae`
      of agent j's rewards under agent i's detached values (JAX stops the
      gradient of the advantages and targets);
    * ``w_ij = exp(sg(log pi_i(a_j|o_j)) - log pi_j,behaviour(a_j|o_j))``,
      pair weight 1 on the diagonal and ``seac_lambda * w`` off it;
    * the policy and value terms summed over (N_i, T, B, N_j) and divided by
      ``T * B * N``, the advantages not normalised; the entropy of each
      agent's own policy (the diagonal).  With message bits the log-prob and
      the entropy are the joint ones over (move, bits).

    The hidden weights' and biases' gradients are float32 sums: the learner
    rounds the whole batch's to bf16 (JAX's cast,
    :func:`~rware_tpu_torch.models.networks.round_grad_blocks`).  Returns
    (total, metrics) with JAX's names: ``pg_loss``, ``v_loss``, ``entropy``,
    ``mean_is_weight`` (the mean of w over every pair)."""
    obs, action, behav_logp, reward, done = (traj[k] for k in ("obs", "action", "logp",
                                                                "reward", "done"))
    t_len, b, n = reward.shape
    heads = [apply_forward(dims.split(p), obs, dims.msg_bits) for p in params]
    values = torch.stack([h[1] for h in heads])  # (N_i, T, B, N_j)
    if dims.msg_bits:
        logits = (torch.stack([h[0][0] for h in heads]), torch.stack([h[0][1] for h in heads]))
        bits = traj["bits"][None]
    else:
        logits, bits = torch.stack([h[0] for h in heads]), None
    last = cross_last_values(dims, params, last_obs)
    adv, target = cross_gae(cfg, reward, values.detach(), done, last)
    logp, ent_map = cross_logp(logits, action[None], bits)  # (N_i, T, B, N_j)
    w = torch.exp(logp.detach() - behav_logp[None])
    eye = torch.eye(n, dtype=torch.float32, device=obs.device)[:, None, None, :]
    weight = eye + cfg.seac_lambda * w * (1.0 - eye)
    pg_loss = -(weight * logp * adv).sum() / (t_len * b * n)
    v_loss = 0.5 * (weight * (values - target) ** 2).sum() / (t_len * b * n)
    entropy = torch.diagonal(ent_map, dim1=0, dim2=-1).mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    return total, {"pg_loss": pg_loss.detach(), "v_loss": v_loss.detach(),
                   "entropy": entropy.detach(), "mean_is_weight": w.mean()}


class SeacA2CTrainStep(_PerAgentRollout):
    """``train_step(runner) -> (runner, metrics)``; see
    :func:`build_seac_train_step`.  The phases are methods so that callers
    can time them and hand in a trajectory of their own: :meth:`rollout`,
    :meth:`update`."""

    def update(self, runner: RunnerState, traj: dict, last_obs: torch.Tensor):
        """((params, opt_state), metrics) of one autograd of
        :func:`seac_a2c_loss` on ``traj`` and ``last_obs`` (with a mesh its
        gradients and metrics averaged over the ranks' equal rollouts, the
        whole batch's, as the loss takes no statistic over the batch) and one
        clip + Adam step over the stack."""
        grads_fn = data_parallel(lambda params: loss_grads(
            lambda p: seac_a2c_loss(self.cfg, self.dims, p, traj, last_obs), params), self.mesh)
        grads, metrics = grads_fn(runner.params)
        grads = round_grad_blocks(self.dims, grads, DENSE_CAST_BLOCKS)  # the whole sum's
        return seac_optimizer_step(self.cfg, runner.params, grads, runner.opt_state), metrics

    def __call__(self, runner: RunnerState) -> Tuple[RunnerState, dict]:
        env_states, traj = self.rollout(runner)
        obs = self.policy_obs(env_states)
        (params, opt_state), metrics = self.update(runner, traj, obs)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, metrics, self.mesh)


def build_seac_train_step(env: Warehouse, dims: BlockDims, cfg: SEACConfig,
                          collect: str = "fused", mesh: Optional[Mesh] = None
                          ) -> SeacA2CTrainStep:
    """SEAC A2C (``build_seac_train_step``, ``seac.py:101-276``):
    ``train_step(runner) -> (runner, metrics)``.  Collects ``cfg.rollout_len``
    autoreset steps with the per-agent collector, by default through its
    kernel (K2d, and K2b with message bits, on a CUDA runner; its plain
    version on a CPU runner), or with ``collect="plain"`` through its plain
    version on any runner (the route of JAX's XLA collect; Philox draws keyed
    by :func:`collect_seed`); the behaviour log-probs are the collector's.
    Then one autograd of :func:`seac_a2c_loss` and one clip + Adam step over
    the (N, P) stack.  The metrics are JAX's: ``pg_loss``, ``v_loss``,
    ``entropy``, ``mean_is_weight``, ``reward_per_env`` and
    ``episodes_done``.  ``mesh`` makes it data parallel (the module's head):
    the runner holds this rank's envs, ``cfg.n_envs`` is the global batch,
    and an update takes two all-reduces (the gradients and metrics, the
    reward sums)."""
    return SeacA2CTrainStep(env, dims, cfg, collect, mesh=mesh)


# ---------------------------------------------------------------------------
# Recurrent SEAC-PPO: per-agent GRU actors with shared experience
# (``seac.py:731-1173``).  Evaluating pi_i on agent j's experience replays
# agent i's GRU over agent j's observation sequence, episode ends included:
# N_i x N_j streams.  The diagonal starts from the carry stored at the
# rollout's start, the other pairs from zeros.
# ---------------------------------------------------------------------------


def init_seac_gru(env: Warehouse, cfg: SEACPPOConfig, seed: int, hidden: int = 128,
                  embed: int = 128, mesh: Optional[Mesh] = None
                  ) -> Tuple[RNNRunnerState, GruDims]:
    """N independent flax-default inits of the recurrent actor-critic
    (``init_seac_gru``, ``seac.py:763-803``), agent i's drawn from
    ``numpy.random.default_rng((seed, 2, i))`` (with a message head where the
    config has message bits), stacked into ``(N, P)``; the optimizer state
    over the stack, a fresh batch of ``cfg.n_envs`` env states and the zero
    carry (B, N, Hg) bf16 on ``env.device`` (with a mesh this rank's rows)."""
    l_obs = env.config.policy_obs_length
    models = [init_recurrent_actor_critic(l_obs, env.n_actions, hidden, embed, (seed, 2, i),
                                          env.config.msg_bits) for i in range(env.n_agents)]
    params = torch.stack([pack_arrays(gru_to_arrays(m)) for m in models]).detach().to(env.device)
    env_states = reset_envs(env, seed, cfg.n_envs, mesh)
    obs = policy_obs_fn(env)(env_states)
    runner = RNNRunnerState(
        params=params, opt_state=optimizer_init(params), env_states=env_states, obs=obs,
        carry=models[0].initialize_carry((env_states.batch_size, env.n_agents), env.device),
        generator=torch.Generator().manual_seed(seed), update_idx=0, seed=seed,
    )
    return runner, GruDims.of(models[0])


def seac_gru_policies_of(dims: GruDims, params: torch.Tensor,
                         models: Optional[nn.ModuleList] = None) -> nn.ModuleList:
    """The N :class:`RecurrentActorCritic` holding the rows of ``params``
    (copied into ``models`` when given) — what the per-agent recurrent
    collector runs."""
    if models is None:
        return nn.ModuleList(rnn_policy_of(dims, p) for p in params)
    for p, model in zip(params, models):
        rnn_policy_of(dims, p, model.to(p.device))
    return models


def stacked_blocks(dims, params: torch.Tensor) -> list:
    """The blocks of an (N, P) stack, each (N, rows, cols) (views)."""
    sizes = [r * c for r, c in dims.shapes]
    return [b.view(params.shape[0], r, c)
            for b, (r, c) in zip(torch.split(params, sizes, dim=1), dims.shapes)]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def _cross_input_gates(blocks, obs: torch.Tensor) -> torch.Tensor:
    """(N_i, R, 3Hg) bf16: every agent's embed and GRU input gates on the
    observations ``obs`` (R, L), in flax's rounding (``Dense`` with
    ``dtype=bfloat16``: each product, bias add and tanh rounded to bf16).
    Time-parallel, so the replay takes them for all steps at once."""
    we, be, wi, bi = blocks[:4]
    e = torch.tanh(torch.matmul(_bf16(obs), _bf16(we)) + _bf16(be))
    return torch.matmul(e, _bf16(wi)) + _bf16(bi)


def _cross_cell(wh: torch.Tensor, bhn: torch.Tensor, h: torch.Tensor,
                gi: torch.Tensor) -> torch.Tensor:
    """flax's ``GRUCell`` with ``dtype=bfloat16`` (``networks.gru_apply_step``)
    on the bf16 carries ``h`` (N_i, R, Hg) and input gates ``gi`` (N_i, R,
    3Hg) of every agent at once: the new hidden (N_i, R, Hg) bf16.  Every op
    rounds to bf16, the sigmoid op by op as XLA expands it (``exp``, the add
    and the division); the weight is cast per step, so that its gradient is
    rounded per step and summed over the steps in float32, as JAX's scan
    sums it."""
    hg = h.shape[-1]
    # split, not slices: one backward op joins the parts' gradients
    gi_rz, gi_n = gi.split([2 * hg, hg], dim=-1)
    gh_rz, gh_n = torch.matmul(h, _bf16(wh)).split([2 * hg, hg], dim=-1)
    r, z = (1.0 / (1.0 + torch.exp(-(gi_rz + gh_rz)))).split(hg, dim=-1)  # r and z at once
    n = torch.tanh(gi_n + r * (gh_n + _bf16(bhn)))
    return (1.0 - z) * n + z * h


def _cross_heads(blocks, hseq: torch.Tensor) -> torch.Tensor:
    """The float32 head block (..., A + 1 + M) of every agent on its bf16
    hidden states ``hseq`` (N_i, R, Hg)."""
    wc, bc = blocks[6:]
    return torch.matmul(hseq.float(), wc) + bc


def gru_cross_replay(dims: GruDims, params: torch.Tensor, obs: torch.Tensor, done: torch.Tensor,
                     h0_diag: torch.Tensor, remat: bool = False):
    """Every agent's GRU over every agent's observation stream
    (``_gru_cross_replay``, ``seac.py:806-843``), in flax's rounding:
    ``params`` (N_i, P), ``obs`` (T, B, N_j, L), ``done`` (T, B), ``h0_diag``
    (B, N_j, Hg) bf16, each agent's own carry at the start (the diagonal's;
    the other pairs start from zeros).  Every stream's carry is zeroed where
    its episode ends.  The N_i agents run as one batched product per step.

    ``remat`` keeps only each step's carry for the backward and computes the
    cell again there (``torch.utils.checkpoint``, as ``jax.checkpoint`` at
    ``seac.py:836-841``); the gradient is the same to the bit.

    Returns (heads, values, last_carry): heads (T, B, N_i, N_j, A) float32,
    ``(logits, msg_logits)`` with message bits; values (T, B, N_i, N_j);
    last_carry (B, N_i, N_j, Hg) bf16."""
    from torch.utils.checkpoint import checkpoint

    t_len, b, n, l_obs = obs.shape
    n_i = params.shape[0]
    blocks = stacked_blocks(dims, params)
    wh, bhn = blocks[4], blocks[5]
    rows = b * n
    gi = _cross_input_gates(blocks, obs.reshape(t_len * rows, l_obs))
    # one view per step by unbind, whose backward stacks the steps' gradients
    # once (indexing gi[:, t] would add a zero-filled gi-sized gradient per step)
    gi = gi.view(n_i, t_len, rows, gi.shape[-1]).unbind(1)
    eye = torch.eye(n_i, n, dtype=torch.bool, device=obs.device)
    h = torch.where(eye[:, None, :, None], h0_diag[None].to(torch.bfloat16),
                    torch.zeros((), dtype=torch.bfloat16, device=obs.device))
    h = h.reshape(n_i, rows, -1)
    # (T, 1, B * N_j, 1): 0 where the stream's episode ended, else 1
    keep = (~done).repeat_interleave(n, dim=1)[:, None, :, None].to(torch.bfloat16)
    hseq = []
    for t in range(t_len):
        if remat:
            new_h = checkpoint(_cross_cell, wh, bhn, h, gi[t], use_reentrant=False)
        else:
            new_h = _cross_cell(wh, bhn, h, gi[t])
        hseq.append(new_h)
        h = new_h * keep[t]
    hcat = _cross_heads(blocks, torch.stack(hseq, dim=1).view(n_i, t_len * rows, -1))
    hcat = hcat.view(n_i, t_len, b, n, -1).permute(1, 2, 0, 3, 4)
    heads, values = split_heads(hcat, dims.msg_bits)
    return heads, values, h.view(n_i, b, n, -1).permute(1, 0, 2, 3)


def cross_bootstrap(dims: GruDims, params: torch.Tensor, last_carry: torch.Tensor,
                    obs: torch.Tensor) -> torch.Tensor:
    """(B, N_i, N_j) bootstrap values: agent i's GRU one step on agent j's
    observation after the rollout (B, N_j, L) from the last cross carry
    (B, N_i, N_j, Hg), in flax's rounding (``seac.py:1061-1068``)."""
    b, n, l_obs = obs.shape
    n_i = params.shape[0]
    blocks = stacked_blocks(dims, params)
    with torch.no_grad():
        gi = _cross_input_gates(blocks, obs.reshape(b * n, l_obs))
        h = last_carry.permute(1, 0, 2, 3).reshape(n_i, b * n, -1)
        hcat = _cross_heads(blocks, _cross_cell(blocks[4], blocks[5], h, gi))
        return split_heads(hcat.view(n_i, b, n, -1).permute(1, 0, 2, 3), dims.msg_bits)[1]


def seac_gru_loss(cfg: SEACPPOConfig, dims: GruDims, params: torch.Tensor, batch,
                  remat: bool = False):
    """The recurrent minibatch loss (``minibatch_loss``, ``seac.py:986-1021``)
    on an env band ``(obs (T, M, N_j, L), done (T, M), action, behaviour logp
    (T, M, N_j), old_value, adv, target (T, M, N_i, N_j), h0_diag (M, N_j,
    Hg))``, and the bits (T, M, N_j, M_bits) as a 9th entry where ``dims`` has
    message bits: the cross replay from the band's carries, the joint
    log-prob and entropy (``cross_logp_ent``, ``seac.py:961-984``), the
    SEAC-PPO objective with advantages normalised over the band.  Returns
    (total, metrics)."""
    obs, done, action, behav_logp, old_value, adv, target, h0_diag = batch[:8]
    heads, values, _ = gru_cross_replay(dims, params, obs, done, h0_diag, remat)
    bits = batch[8][:, :, None] if dims.msg_bits else None
    return seac_terms(cfg, cfg.seac_lambda, heads, values, action[:, :, None],
                      behav_logp[:, :, None], old_value, adv, target, 2, bits=bits)


def seac_gru_remat(cfg: SEACPPOConfig, dims: GruDims, n_agents: int) -> bool:
    """JAX's rule (``seac.py:899-909``) with the model's GRU width where JAX
    has a literal 128: remat once the band replay's autodiff residuals, about
    ``4 T (B / M) N^2 4 Hg`` elements, pass 2^31."""
    resid = 4.0 * cfg.rollout_len * (cfg.n_envs // cfg.minibatches) * n_agents * n_agents \
        * 4 * dims.hidden
    return resid > 2**31


class SeacGruTrainStep:
    """``train_step(runner, offsets=None) -> (runner, metrics)``; see
    :func:`build_seac_gru_train_step`.  The phases are methods so that
    callers can time them: :meth:`rollout`, :meth:`advantages`,
    :meth:`update`."""

    def __init__(self, env: Warehouse, dims: GruDims, cfg: SEACPPOConfig,
                 deterministic_collect: bool, mesh: Optional[Mesh] = None,
                 collect: str = "fused"):
        if collect not in ("fused", "plain"):
            raise ValueError(f"collect must be 'fused' or 'plain', got {collect!r}")
        if collect == "plain" and deterministic_collect:
            raise ValueError("collect='plain' is JAX's XLA collect: it has no deterministic mode")
        self.env_offset = 0 if mesh is None else mesh.env_offset(cfg.n_envs)
        self.n_local = cfg.n_envs if mesh is None else mesh.n_local(cfg.n_envs)
        if self.n_local % cfg.minibatches:
            raise ValueError(f"minibatches={cfg.minibatches} must divide the {self.n_local} "
                             "envs of a shard (env-band minibatches)")
        self.env, self.dims, self.cfg, self.mesh = env, dims, cfg, mesh
        self.policy_obs = policy_obs_fn(env)
        if collect == "plain":
            self.collect = build_scan_collect(env, cfg.rollout_len, self.forward)
        else:
            self.collect = build_fused_collect_gru_per_agent(env.config, cfg.rollout_len,
                                                             (dims.embed, dims.hidden),
                                                             deterministic=deterministic_collect)
        # the shard's band (seac.py:901-909 read n_local)
        self.remat = seac_gru_remat(dataclasses.replace(cfg, n_envs=self.n_local), dims,
                                    env.n_agents)
        self._policies = None

    def forward(self, params: torch.Tensor, obs: torch.Tensor, carry: torch.Tensor):
        """(heads, new carry) of every agent's GRU one step on its own
        observations (B, N, L) from its own carry (B, N, Hg), in the flax
        module's rounding (:func:`~rware_tpu_torch.models.networks.
        gru_apply_step`, ``apply_own`` of ``seac.py:939-944``)."""
        h, heads, _ = zip(*(gru_apply_step(self.dims.split(params[i]), carry[:, i], obs[:, i],
                                           self.dims.msg_bits) for i in range(params.shape[0])))
        if self.dims.msg_bits:  # (logits, msg_logits) of each agent
            return tuple(torch.stack(x, 1) for x in zip(*heads)), torch.stack(h, 1)
        return torch.stack(heads, 1), torch.stack(h, 1)

    def rollout(self, runner: RNNRunnerState):
        """(env_states, new_carry, traj) of one per-agent recurrent collector
        launch (or the plain collect) from the runner's carry with this
        update's key."""
        seed = collect_seed(runner.seed, runner.update_idx)
        if isinstance(self.collect, ScanCollect):
            return self.collect(runner.env_states, runner.params, seed, runner.carry,
                                self.env_offset)
        self._policies = seac_gru_policies_of(self.dims, runner.params, self._policies)
        return self.collect(runner.env_states, self._policies, seed, runner.carry,
                            self.env_offset)

    def advantages(self, runner: RNNRunnerState, env_states, traj):
        """(obs after the rollout, cross values, advantages, targets), the
        cross arrays (T, B, N_i, N_j): the old policies' cross replay from
        the runner's carry, the bootstrap from its last carry, cross GAE
        (``seac.py:1061-1085``)."""
        dims, params = self.dims, runner.params
        obs = self.policy_obs(env_states)
        with torch.no_grad():
            _, values, last_carry = gru_cross_replay(dims, params, traj["obs"], traj["done"],
                                                     runner.carry)
        last = cross_bootstrap(dims, params, last_carry, obs)
        adv, targets = cross_gae(self.cfg, traj["reward"], values.permute(2, 0, 1, 3),
                                 traj["done"], last.permute(1, 0, 2))
        return obs, values, adv.permute(1, 2, 0, 3), targets.permute(1, 2, 0, 3)

    def update(self, runner: RNNRunnerState, dataset, offsets: Optional[Sequence[int]] = None):
        """((params, opt_state), metrics) of the E x M env bands of
        ``dataset`` (obs, done, action, logp, values, adv, targets in the
        ``(T, B, ...)`` layout, the carry at the rollout's start (B, N, Hg),
        and the bits with message bits): epoch e rolls the envs by
        ``offsets[e]`` in [0, B) (drawn from the runner's generator if None)
        and band m takes envs ``(m * B / M - offsets[e]) % B`` onwards
        (``seac.py:1108-1128``); each band is one autograd of
        :func:`seac_gru_loss` (with a mesh, its mean over the ranks) and one
        optimizer step over the stack.  B is this rank's envs."""
        cfg, dims = self.cfg, self.dims
        b = self.n_local
        mb = b // cfg.minibatches
        grads_fn = data_parallel(
            lambda p, band: loss_grads(lambda q: seac_gru_loss(cfg, dims, q, band, self.remat),
                                       p), self.mesh)
        if offsets is None:
            offsets = torch.randint(0, b, (cfg.epochs,), generator=runner.generator)
        params, opt_state = runner.params, runner.opt_state
        per_pass = []
        for off in torch.as_tensor(offsets).tolist():
            for m in range(cfg.minibatches):
                start = (m * mb - int(off)) % b
                band = [band_slice(x, start, mb) for x in dataset]
                band[7] = band_slice(dataset[7][None], start, mb)[0]  # the carry: (B, N, Hg)
                grads, metrics = grads_fn(params, band)
                params, opt_state = seac_optimizer_step(cfg, params, grads, opt_state)
                per_pass.append(metrics)
        return (params, opt_state), mean_metrics(per_pass)

    def __call__(self, runner: RNNRunnerState, offsets: Optional[Sequence[int]] = None
                 ) -> Tuple[RNNRunnerState, dict]:
        env_states, new_carry, traj = self.rollout(runner)
        obs, values, adv, targets = self.advantages(runner, env_states, traj)
        dataset = (traj["obs"], traj["done"], traj["action"], traj["logp"], values, adv, targets,
                   runner.carry)
        if self.dims.msg_bits:
            dataset += (traj["bits"],)
        (params, opt_state), ppo = self.update(runner, dataset, offsets)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs, carry=new_carry,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, ppo, self.mesh)


def build_seac_gru_train_step(env: Warehouse, dims: GruDims, cfg: SEACPPOConfig,
                              deterministic_collect: bool = False,
                              mesh: Optional[Mesh] = None,
                              collect: str = "fused") -> SeacGruTrainStep:
    """The recurrent SEAC-PPO learner (``build_seac_gru_train_step``,
    ``seac.py:846-1173``, ``collect_mode="pallas"``): K2d′ collect from the
    runner's carry (its plain version on a CPU runner), the old policies'
    cross replay and bootstrap, cross GAE, then per epoch one env offset in
    [0, B) and M env bands, each autograd of the cross-replay loss
    (:func:`seac_gru_loss`, remat where :func:`seac_gru_remat` asks for it)
    and one clip + Adam step over the stack.  ``offsets`` of a call
    overrides the (E,) offsets drawn from the runner's generator.  With
    message bits the collector runs its message mode (K2b) and the loss is
    the joint one.  ``mesh`` makes the step data parallel (the module's
    head): the runner holds this rank's envs and ``cfg.n_envs`` is the global
    batch.

    ``collect="plain"`` is JAX's ``collect_mode="xla"`` (``seac.py:939-960,
    1048-1059``): the plain collect
    (:func:`~rware_tpu_torch.parallel.rollout.build_scan_collect`, Philox
    draws keyed by :func:`collect_seed` and the global env index) with
    each agent's GRU in the flax module's rounding
    (:meth:`SeacGruTrainStep.forward`) in place of K2d′; the rest is the
    same, and no kernel runs on any device."""
    return SeacGruTrainStep(env, dims, cfg, deterministic_collect, mesh, collect)
