"""MAPPO: centralized-critic PPO on the fused kernels — the counterpart of
``rware_tpu/models/mappo.py`` on its combined path (``fused_critic_update``).

Decentralized shared-parameter actors (the MLP the fused collector K2a runs;
its local value head is unused) and a :class:`~rware_tpu_torch.models.networks.
CentralCritic` on the joint observation.  One update (``mappo.py:580-682``):

1. K2a collects the trajectory with the actor's parameters;
2. K6 (:class:`~rware_tpu_torch.ops.fused_mappo.FusedCriticValues`) gives the
   critic's values of every stored step, in the kernels' rounding;
3. the bootstrap value is the critic on the post-rollout joint observation
   in flax's rounding (:func:`~rware_tpu_torch.models.networks.critic_apply_forward`);
4. GAE on the critic's values;
5. the update phase over ``(obs, action, logp, critic values, adv, target)``:
   the whole-phase kernel K7, or E x M passes of K5 each followed by the split
   optimizer step.

Parameters and optimizer state are ``{"actor", "critic"}`` dicts of flat
vectors and :class:`~rware_tpu_torch.models.ppo.AdamState`: each part has its
own global-norm clip and Adam chain (``make_mappo_optimizer``).

With message bits (``msg_bits`` M > 0) the learner takes JAX's split path
(``mappo.py:349-370, 446-505``), since the combined kernels K5 and K7 have no
message head: K2a collects in its message mode (K2b); K6 gives the critic's
values (the rounding of ``_critic_rowmajor_forward``, ``mappo.py:594-598``);
each pass takes the actor's gradient from K4 with the message head and
``vf_coef = 0``, and the critic's from autograd of its clipped value loss on
the window's joint observations (:class:`MappoSplitGrads`), then the split
optimizer step.

Recurrent MAPPO (``build_rnn_mappo_train_step``, ``mappo.py:706-1012``) pairs
the GRU actor of :mod:`rware_tpu_torch.models.ippo_rnn` with the central
critic (:class:`RnnMappoTrainStep`): K2c collects (with K2b under message
bits), K6 gives the critic's values of the whole trajectory, then per env
band the actor's gradient of the replay loss with ``vf_coef = 0`` through K9
and K10, and the critic's from K5 ``with_actor=False`` on a contiguous copy
of the band's joint observations, values and targets; one split optimizer
step per band.

JAX's ``collect_mode="xla"`` learner (``build_mappo_train_step(...,
collect="plain")``, :class:`MappoPlainTrainStep`; ``train --collect plain``)
runs no kernel: the plain collect of
:func:`~rware_tpu_torch.parallel.rollout.build_scan_collect` with the actor in
flax's rounding (``actor.apply``, ``mappo.py:289-310``), the critic's values
in ``_critic_native_forward``'s (``mappo.py:600-604``), GAE, then E x M
time-window passes of :class:`MappoLossGrads`, autograd of
:func:`~rware_tpu_torch.models.ppo.mappo_loss_native` (the joint loss with
message bits) with the tanh's gradient as JAX's autodiff gives it and the
hidden kernels' gradients rounded to bf16, each followed by the split
optimizer step.

All three learners take a :class:`~rware_tpu_torch.parallel.sharding.Mesh`
(``mesh=`` of ``mappo.py:205, 767``): this rank collects its own rows of the
global batch, the critic's values and GAE run on them, and each pass's
gradients (both parts) and metrics leave as their mean over the ranks.  The
whole-phase kernel K7 (``fused_critic_phase``) is refused under a mesh, as JAX
refuses it (``mappo.py:388-392``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.models.ippo import (
    IPPOConfig,
    RunnerState,
    adam_hyper,
    collect_seed,
    compute_gae,
    optimizer_init,
    optimizer_step,
    policy_obs_fn,
    policy_of,
    reset_envs,
    update_metrics,
)
from rware_tpu_torch.models.ippo_fused import (
    WHOLE_PHASE_UNDER_MESH,
    phase_advstats,
    phase_window_starts,
    ppo_update_epochs_native,
)
from rware_tpu_torch.models.ippo_rnn import (
    RNNRunnerState,
    band_passes,
    band_rows,
    band_slice,
    rnn_policy_of,
    rnn_ppo_loss_native,
)
from rware_tpu_torch.models.networks import (
    BlockDims,
    CriticDims,
    GruDims,
    apply_forward,
    critic_apply_forward,
    critic_to_arrays,
    critic_train_forward,
    gru_to_arrays,
    init_actor_critic,
    init_central_critic,
    init_recurrent_actor_critic,
    joint_obs,
    pack_arrays,
    params_to_arrays,
    round_grad_blocks,
)
from rware_tpu_torch.models.ppo import (
    AdamState,
    critic_value_loss,
    loss_grads,
    mappo_loss_native,
)
from rware_tpu_torch.ops.fused_mappo import (
    build_fused_critic_values,
    build_fused_mappo_grads,
    build_fused_mappo_update_phase,
)
from rware_tpu_torch.ops.fused_gru import build_fused_gru_obs_bwd, build_fused_gru_obs_fwd
from rware_tpu_torch.ops.fused_rollout import build_fused_collect, build_fused_collect_gru
from rware_tpu_torch.ops.fused_update import build_fused_ppo_grads, metric_means, window_rows
from rware_tpu_torch.parallel.rollout import build_scan_collect
from rware_tpu_torch.parallel.sharding import Mesh, data_parallel, refuse_under_mesh

PARTS = ("actor", "critic")
# the blocks whose gradient JAX's ``_native_trunk`` rounds to bf16: the hidden
# kernels, cast to bf16 for their products (the biases join the f32 sums)
TRUNK_CAST_BLOCKS = (0, 2)

__all__ = [
    "MappoLossGrads", "MappoPlainTrainStep", "MappoSplitGrads", "MappoTrainStep",
    "RnnMappoTrainStep", "build_mappo_train_step",
    "build_rnn_mappo_train_step", "critic_last_values", "init_mappo_runner",
    "init_rnn_mappo_runner", "mappo_optimizer_step", "mappo_update_phase_fused",
]


def init_mappo_runner(env: Warehouse, cfg: IPPOConfig, seed: int,
                      hidden: Tuple[int, int] = (128, 128),
                      critic_hidden: Tuple[int, int] = (128, 128), mesh: Optional[Mesh] = None
                      ) -> Tuple[RunnerState, BlockDims, CriticDims]:
    """Actor (with a message head where the config has message bits) and
    central-critic parameters (flax's default init: the actor
    from ``seed``, the critic from the stream ``(seed, 1)``), the split
    optimizer state and a fresh batch of ``cfg.n_envs`` env states on
    ``env.device`` (with a mesh this rank's rows); ``runner.params`` and
    ``runner.opt_state`` are ``{"actor", "critic"}`` dicts."""
    l_obs, n = env.config.policy_obs_length, env.n_agents
    actor = init_actor_critic(l_obs, env.n_actions, hidden, seed, env.config.msg_bits)
    critic = init_central_critic(n * l_obs, n, critic_hidden, (seed, 1))
    params = {"actor": pack_arrays(params_to_arrays(actor)).detach().to(env.device),
              "critic": pack_arrays(critic_to_arrays(critic)).detach().to(env.device)}
    env_states = reset_envs(env, seed, cfg.n_envs, mesh)
    obs = policy_obs_fn(env)(env_states)
    runner = RunnerState(
        params=params, opt_state={k: optimizer_init(params[k]) for k in PARTS},
        env_states=env_states, obs=obs, generator=torch.Generator().manual_seed(seed),
        update_idx=0, seed=seed,
    )
    return runner, BlockDims.of(actor), CriticDims.of(critic)


def critic_last_values(cdims: CriticDims, cparams: torch.Tensor, obs: torch.Tensor
                       ) -> torch.Tensor:
    """(B, N) bootstrap values of the observations (B, N, L) after the
    rollout, by flax's ``critic.apply`` recipe (``mappo.py:604-607``)."""
    with torch.no_grad():
        return critic_apply_forward(cdims.split(cparams), joint_obs(obs))


def mappo_optimizer_step(cfg: IPPOConfig, params, grads, opt_state: Dict[str, AdamState]):
    """The split optimizer (``mappo.py:120-150``): each part is clipped by its
    own global norm and takes its own Adam step."""
    new = {k: optimizer_step(cfg, params[k], grads[k], opt_state[k]) for k in PARTS}
    return {k: new[k][0] for k in PARTS}, {k: new[k][1] for k in PARTS}


def mappo_update_phase_fused(cfg: IPPOConfig, params, opt_state: Dict[str, AdamState], dataset,
                             generator: torch.Generator, update_fn,
                             starts: Optional[torch.Tensor] = None):
    """The whole update phase through ``update_fn``
    (:class:`~rware_tpu_torch.ops.fused_mappo.FusedMappoUpdatePhase`): window
    starts, advantage stats (from per-time-row moments) and Adam hyper rows
    (from the actor's count, which drives both parts: ``mappo.py:1083-1098``)
    are computed here, the kernel does the rest; both counts advance by P.
    Returns ((params, opt_state), metrics)."""
    action = dataset[1]
    dev = action.device
    t_full = action.shape[0]
    mb_t = t_full // cfg.minibatches
    n_passes = cfg.epochs * cfg.minibatches
    if starts is None:
        starts = phase_window_starts(cfg, t_full, update_fn.time_block, generator)
    starts = torch.as_tensor(starts, device=dev).to(torch.int64)
    advstats = phase_advstats(dataset[4], starts, mb_t)
    hyper = adam_hyper(cfg, opt_state["actor"].count, n_passes).to(dev)
    mu = {k: opt_state[k].mu for k in PARTS}
    nu = {k: opt_state[k].nu for k in PARTS}
    params, mu, nu, mets = update_fn(params, mu, nu, dataset, starts, advstats, hyper)
    n = mb_t * action.shape[1] * action.shape[2]
    metrics = {k: v.mean() for k, v in metric_means(mets, n).items()}
    new_opt = {k: AdamState(opt_state[k].count + n_passes, mu[k], nu[k]) for k in PARTS}
    return (params, new_opt), metrics


class MappoSplitGrads:
    """``grads(params, dataset, start) -> ({"actor", "critic"} grads, sums
    (4,))`` of one window on MAPPO's split path (``mappo.py:446-500``): the
    actor's from K4 (:class:`~rware_tpu_torch.ops.fused_update.FusedPPOGrads`,
    message head and ``vf_coef = 0``, so the local value head's gradient is
    zero), the critic's from autograd of :func:`critic_value_loss` on the
    window's joint observations, critic values and targets (rows ``(start +
    t) % T``); its forward is the rounding of JAX's
    ``_critic_rowmajor_forward`` (``mappo.py:84-97``).  The sums are K4's
    with the critic's value loss in place of the actor's."""

    def __init__(self, dims: BlockDims, cdims: CriticDims, cfg: IPPOConfig):
        self.t_mb = cfg.rollout_len // cfg.minibatches
        self.cdims, self.cfg = cdims, cfg
        self.actor = build_fused_ppo_grads(dims, self.t_mb, cfg.clip_eps, 0.0, cfg.ent_coef)

    def __call__(self, params, dataset, start):
        grads, sums = self.actor(params["actor"], dataset, start)
        obs, values, targets = dataset[0], dataset[3], dataset[5]
        rows = window_rows(start, self.t_mb, obs.shape[0], obs.device)
        batch = tuple(x.index_select(0, rows) for x in (obs, values, targets))
        cgrads, cmets = loss_grads(
            lambda p: critic_value_loss(self.cfg, self.cdims, p, batch), params["critic"])
        sums = torch.cat([sums[:1], (cmets["v_loss"] * batch[1].numel()).reshape(1), sums[2:]])
        return {"actor": grads, "critic": cgrads}, sums


class MappoTrainStep:
    """``train_step(runner, starts=None) -> (runner, metrics)``; see
    :func:`build_mappo_train_step`.  The phases are methods so that callers
    can time them: :meth:`rollout`, :meth:`values`, :meth:`advantages`,
    :meth:`update`."""

    def __init__(self, env: Warehouse, dims: BlockDims, cdims: CriticDims, cfg: IPPOConfig,
                 deterministic_collect: bool = False, fused_critic_phase: bool = False,
                 mesh: Optional[Mesh] = None):
        if fused_critic_phase:
            refuse_under_mesh(mesh, "fused_critic_phase (the whole-MAPPO-phase kernel K7)",
                              WHOLE_PHASE_UNDER_MESH)
        self.env, self.dims, self.cdims, self.cfg, self.mesh = env, dims, cdims, cfg, mesh
        self.env_offset = 0 if mesh is None else mesh.env_offset(cfg.n_envs)
        self.policy_obs = policy_obs_fn(env)
        self.collect = build_fused_collect(env.config, cfg.rollout_len, (dims.h1, dims.h2),
                                           deterministic=deterministic_collect)
        self.critic_values = build_fused_critic_values(cdims)
        if dims.msg_bits:
            if fused_critic_phase:
                raise NotImplementedError("the whole-MAPPO-phase kernel takes no message head "
                                          "(as mappo.py:369-393)")
            self.grads = MappoSplitGrads(dims, cdims, cfg)
        else:
            self.grads = build_fused_mappo_grads(dims, cdims, cfg.rollout_len // cfg.minibatches,
                                                 cfg.clip_eps, cfg.vf_coef, cfg.ent_coef)
        self.update_phase = None
        if fused_critic_phase:
            self.update_phase = build_fused_mappo_update_phase(
                dims, cdims, cfg.rollout_len, cfg.epochs, cfg.minibatches, cfg.clip_eps,
                cfg.vf_coef, cfg.ent_coef, cfg.max_grad_norm)
        self._policy = None

    def rollout(self, runner: RunnerState):
        """(env_states, traj) of one collector launch with the actor's
        parameters and this update's key."""
        actor = runner.params["actor"]
        self._policy = policy_of(self.dims, actor,
                                 None if self._policy is None else self._policy.to(actor.device))
        seed = collect_seed(runner.seed, runner.update_idx)
        return self.collect(runner.env_states, self._policy, seed, self.env_offset)

    def values(self, runner: RunnerState, traj: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(T, B, N) values of the central critic over the stored trajectory."""
        return self.critic_values(runner.params["critic"], traj["obs"])

    def advantages(self, runner: RunnerState, env_states, traj, values):
        """(obs after the rollout, advantages, targets) on the critic's values."""
        obs = self.policy_obs(env_states)
        last = critic_last_values(self.cdims, runner.params["critic"], obs)
        adv, targets = compute_gae(self.cfg, traj["reward"], values, traj["done"], last)
        return obs, adv, targets

    def update(self, runner: RunnerState, dataset, starts: Optional[torch.Tensor] = None):
        """((params, opt_state), metrics) of the E x M update passes."""
        if self.update_phase is not None:
            return mappo_update_phase_fused(self.cfg, runner.params, runner.opt_state, dataset,
                                            runner.generator, self.update_phase, starts)
        return ppo_update_epochs_native(self.cfg, runner.params, runner.opt_state, dataset,
                                        runner.generator, data_parallel(self.grads, self.mesh),
                                        starts, step_fn=mappo_optimizer_step)

    def __call__(self, runner: RunnerState, starts: Optional[torch.Tensor] = None
                 ) -> Tuple[RunnerState, dict]:
        env_states, traj = self.rollout(runner)
        values = self.values(runner, traj)
        obs, adv, targets = self.advantages(runner, env_states, traj, values)
        dataset = (traj["obs"], traj["action"], traj["logp"], values, adv, targets)
        if "bits" in traj:
            dataset += (traj["bits"],)
        (params, opt_state), ppo = self.update(runner, dataset, starts)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, ppo, self.mesh)


class MappoLossGrads:
    """``grads(params, dataset, start) -> ({"actor", "critic"} grads,
    metrics)`` of one time window on JAX's XLA path (``mappo.py:572-578``):
    autograd of :func:`~rware_tpu_torch.models.ppo.mappo_loss_native` over
    the dataset's rows ``(start + t) % T`` (the bits as its 7th entry with
    message bits), both parts' hidden kernels' gradients then rounded to
    bf16 (:data:`TRUNK_CAST_BLOCKS`), as JAX differentiates their casts."""

    def __init__(self, dims: BlockDims, cdims: CriticDims, cfg: IPPOConfig):
        self.t_mb = cfg.rollout_len // cfg.minibatches
        self.dims, self.cdims, self.cfg = dims, cdims, cfg

    def __call__(self, params, dataset, start):
        rows = window_rows(start, self.t_mb, dataset[0].shape[0], dataset[0].device)
        batch = tuple(x.index_select(0, rows) for x in dataset)
        grads, metrics = loss_grads(
            lambda p: mappo_loss_native(self.cfg, self.dims, self.cdims, p, batch,
                                        xla_grad=True), params)
        return {k: round_grad_blocks(d, grads[k], TRUNK_CAST_BLOCKS)
                for k, d in zip(PARTS, (self.dims, self.cdims))}, metrics


class MappoPlainTrainStep(MappoTrainStep):
    """``train_step(runner, starts=None) -> (runner, metrics)``; see
    :func:`build_mappo_train_step` with ``collect="plain"``.  The phases
    are :class:`MappoTrainStep`'s methods."""

    def __init__(self, env: Warehouse, dims: BlockDims, cdims: CriticDims, cfg: IPPOConfig,
                 mesh: Optional[Mesh] = None):
        self.env, self.dims, self.cdims, self.cfg, self.mesh = env, dims, cdims, cfg, mesh
        self.env_offset = 0 if mesh is None else mesh.env_offset(cfg.n_envs)
        self.policy_obs = policy_obs_fn(env)
        self.collect = build_scan_collect(env, cfg.rollout_len, self.forward)
        self.grads = MappoLossGrads(dims, cdims, cfg)

    def forward(self, actor: torch.Tensor, obs: torch.Tensor, carry=None):
        """The actor's heads on ``obs`` by flax's ``actor.apply`` recipe
        (:func:`~rware_tpu_torch.models.networks.apply_forward`); no carry."""
        return apply_forward(self.dims.split(actor), obs, self.dims.msg_bits)[0], None

    def rollout(self, runner: RunnerState):
        """(env_states, traj) of the plain collect with the actor's
        parameters and this update's key, on this rank's envs at their
        global indices."""
        seed = collect_seed(runner.seed, runner.update_idx)
        return self.collect(runner.env_states, runner.params["actor"], seed,
                            env_offset=self.env_offset)

    def values(self, runner: RunnerState, traj: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(T, B, N) values of the central critic over the stored trajectory
        in the rounding of ``_critic_native_forward`` (``mappo.py:600-604``)."""
        with torch.no_grad():
            return critic_train_forward(self.cdims.split(runner.params["critic"]),
                                        joint_obs(traj["obs"]))

    def update(self, runner: RunnerState, dataset, starts: Optional[torch.Tensor] = None):
        """((params, opt_state), metrics) of the E x M time-window passes,
        each :class:`MappoLossGrads` (with a mesh, their mean over the ranks)
        and the split optimizer step."""
        return ppo_update_epochs_native(self.cfg, runner.params, runner.opt_state, dataset,
                                        runner.generator, data_parallel(self.grads, self.mesh),
                                        starts, step_fn=mappo_optimizer_step)


def build_mappo_train_step(env: Warehouse, dims: BlockDims, cdims: CriticDims, cfg: IPPOConfig,
                           deterministic_collect: bool = False,
                           fused_critic_phase: bool = False,
                           mesh: Optional[Mesh] = None, collect: str = "fused"):
    """The MAPPO learner on the combined path of ``build_mappo_train_step``
    (``mappo.py:192-235``): K2a collect, K6 critic values, GAE, then the
    update phase.

    ``fused_critic_phase`` runs all E x M passes for both parts and both
    clip -> Adam chains in the K7 kernel; otherwise (default) each pass takes
    the K5 gradients, then the split optimizer step.  With message bits each
    pass takes :class:`MappoSplitGrads` (K4 and the critic's autograd)
    instead of K5, and ``fused_critic_phase`` raises.  ``starts`` of a call
    overrides the (P,) window starts drawn from the runner's generator.
    ``mesh`` makes the step data parallel (the module's head; with it
    ``fused_critic_phase`` raises).  On a CUDA runner every kernel runs on
    the card; on a CPU runner every wrapper runs its plain version.

    ``collect="plain"`` builds JAX's ``collect_mode="xla"`` learner
    (:class:`MappoPlainTrainStep`, ``mappo.py:271-346, 572-578``), which
    runs no kernel on any device: the plain collect with the actor in flax's
    rounding (:func:`~rware_tpu_torch.parallel.rollout.build_scan_collect`,
    Philox draws keyed by :func:`collect_seed` and the global env index),
    the critic's values in ``_critic_native_forward``'s rounding, GAE, then
    E x M passes of :class:`MappoLossGrads` over time windows, each
    followed by the split optimizer step; with message bits the same, the
    loss the joint one.  Under a mesh each shard normalises its own
    advantages and each pass's gradients are averaged over the ranks, as
    ``shard_map`` does.  ``fused_critic_phase`` and ``deterministic_collect``
    raise with it."""
    if collect == "plain":
        if fused_critic_phase or deterministic_collect:
            raise ValueError("collect='plain' is JAX's XLA learner: no whole-MAPPO-phase "
                             "kernel (mappo.py:386-393) and no deterministic collect")
        return MappoPlainTrainStep(env, dims, cdims, cfg, mesh)
    if collect != "fused":
        raise ValueError(f"collect must be 'fused' or 'plain', got {collect!r}")
    return MappoTrainStep(env, dims, cdims, cfg, deterministic_collect, fused_critic_phase,
                          mesh)


def init_rnn_mappo_runner(env: Warehouse, cfg: IPPOConfig, seed: int, hidden: int = 128,
                          embed: int = 128, critic_hidden: Tuple[int, int] = (128, 128),
                          mesh: Optional[Mesh] = None
                          ) -> Tuple[RNNRunnerState, GruDims, CriticDims]:
    """Recurrent MAPPO's runner (``init_rnn_mappo_runner``, ``mappo.py:706-755``):
    the GRU actor (with a message head where the config has message bits)
    from ``seed`` and the central critic from the stream ``(seed, 1)``,
    flax's default init; the split optimizer state, a fresh batch of
    ``cfg.n_envs`` env states and the zero carry on ``env.device`` (with a
    mesh this rank's rows)."""
    l_obs, n = env.config.policy_obs_length, env.n_agents
    actor = init_recurrent_actor_critic(l_obs, env.n_actions, hidden, embed, seed,
                                        env.config.msg_bits)
    critic = init_central_critic(n * l_obs, n, critic_hidden, (seed, 1))
    params = {"actor": pack_arrays(gru_to_arrays(actor)).detach().to(env.device),
              "critic": pack_arrays(critic_to_arrays(critic)).detach().to(env.device)}
    env_states = reset_envs(env, seed, cfg.n_envs, mesh)
    runner = RNNRunnerState(
        params=params, opt_state={k: optimizer_init(params[k]) for k in PARTS},
        env_states=env_states, obs=policy_obs_fn(env)(env_states),
        carry=actor.initialize_carry((env_states.batch_size, n), env.device),
        generator=torch.Generator().manual_seed(seed), update_idx=0, seed=seed,
    )
    return runner, GruDims.of(actor), CriticDims.of(critic)


class RnnMappoTrainStep:
    """``train_step(runner, offsets=None) -> (runner, metrics)``; see
    :func:`build_rnn_mappo_train_step`.  The phases are methods so that
    callers can time them: :meth:`rollout`, :meth:`values`,
    :meth:`advantages`, :meth:`update`."""

    def __init__(self, env: Warehouse, dims: GruDims, cdims: CriticDims, cfg: IPPOConfig,
                 deterministic_collect: bool = False, mesh: Optional[Mesh] = None):
        self.env_offset = 0 if mesh is None else mesh.env_offset(cfg.n_envs)
        n_local = cfg.n_envs if mesh is None else mesh.n_local(cfg.n_envs)
        self.local_cfg = dataclasses.replace(cfg, n_envs=n_local)  # the shard's band plan
        band_rows(self.local_cfg)
        self.env, self.dims, self.cdims, self.cfg, self.mesh = env, dims, cdims, cfg, mesh
        # the actor trains on the clipped surrogate and the entropy only
        self.actor_cfg = dataclasses.replace(cfg, vf_coef=0.0)
        self.policy_obs = policy_obs_fn(env)
        self.collect = build_fused_collect_gru(env.config, cfg.rollout_len,
                                               (dims.embed, dims.hidden),
                                               deterministic=deterministic_collect)
        self.critic_values = build_fused_critic_values(cdims)
        self.gru_fwd = build_fused_gru_obs_fwd(dims)
        self.gru_bwd = build_fused_gru_obs_bwd(dims)
        self.critic_grads = build_fused_mappo_grads(None, cdims, cfg.rollout_len, cfg.clip_eps,
                                                    cfg.vf_coef, cfg.ent_coef, with_actor=False)
        self._policy = None

    def rollout(self, runner: RNNRunnerState):
        """(env_states, new_carry, traj) of one collector launch with the
        actor's parameters from the runner's carry."""
        actor = runner.params["actor"]
        self._policy = rnn_policy_of(self.dims, actor, None if self._policy is None
                                     else self._policy.to(actor.device))
        seed = collect_seed(runner.seed, runner.update_idx)
        return self.collect(runner.env_states, self._policy, seed, runner.carry, self.env_offset)

    def values(self, runner: RNNRunnerState, traj: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(T, B, N) values of the central critic over the stored trajectory."""
        return self.critic_values(runner.params["critic"], traj["obs"])

    def advantages(self, runner: RNNRunnerState, env_states, traj, values):
        """(obs after the rollout, advantages, targets) on the critic's values."""
        obs = self.policy_obs(env_states)
        last = critic_last_values(self.cdims, runner.params["critic"], obs)
        adv, targets = compute_gae(self.cfg, traj["reward"], values, traj["done"], last)
        return obs, adv, targets

    def band_grads(self, params, dataset, band):
        """({"actor", "critic"} gradients, metrics) of one env band
        ``(start_env, n_env)`` (``mappo.py:930-954``): the actor's by autograd
        of the replay loss with ``vf_coef = 0`` around K9 and K10, the
        critic's from one K5 launch on a contiguous copy of the band's
        observations, critic values and targets, all T rows; ``v_loss`` is
        the critic's."""
        ag, metrics = loss_grads(
            lambda p: rnn_ppo_loss_native(self.actor_cfg, self.dims, p, dataset, band,
                                          self.gru_fwd, self.gru_bwd), params["actor"])
        obs, values, targets = (band_slice(dataset[k], *band).contiguous() for k in (0, 4, 6))
        cg, sums = self.critic_grads(params["critic"], (obs, values, targets), 0)
        metrics = {**metrics, "v_loss": sums[1] / values.numel()}
        return {"actor": ag, "critic": cg}, metrics

    def update(self, runner: RNNRunnerState, dataset, offsets: Optional[torch.Tensor] = None):
        """((params, opt_state), metrics) of the E x M band passes, each
        :meth:`band_grads` and one split optimizer step
        (:func:`~rware_tpu_torch.models.ippo_rnn.band_passes`)."""
        grads_fn = data_parallel(lambda p, band: self.band_grads(p, dataset, band), self.mesh)
        return band_passes(self.local_cfg, runner, offsets, grads_fn, mappo_optimizer_step)

    def __call__(self, runner: RNNRunnerState, offsets: Optional[torch.Tensor] = None
                 ) -> Tuple[RNNRunnerState, dict]:
        env_states, new_carry, traj = self.rollout(runner)
        values = self.values(runner, traj)
        obs, adv, targets = self.advantages(runner, env_states, traj, values)
        dataset = (traj["obs"], traj["done"], traj["action"], traj["logp"], values, adv,
                   targets, runner.carry)
        if "bits" in traj:
            dataset += (traj["bits"],)
        (params, opt_state), ppo = self.update(runner, dataset, offsets)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs, carry=new_carry,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, ppo, self.mesh)


def build_rnn_mappo_train_step(env: Warehouse, dims: GruDims, cdims: CriticDims,
                               cfg: IPPOConfig, deterministic_collect: bool = False,
                               mesh: Optional[Mesh] = None) -> RnnMappoTrainStep:
    """Recurrent MAPPO on the kernels (``build_rnn_mappo_train_step``,
    ``mappo.py:758-1012``, with its default ``fused_critic_update``): K2c
    collect from the runner's carry (its message mode K2b with message
    bits), K6 values of the whole trajectory, the critic's bootstrap in
    flax's rounding, GAE, then per epoch one row offset and M env-band passes
    (:func:`~rware_tpu_torch.models.ippo_rnn.epoch_band_starts`), each
    :meth:`RnnMappoTrainStep.band_grads` and the split optimizer step.  With
    message bits the dataset's 9th entry switches the actor to the joint move
    + Bernoulli loss; the critic does not see the bits.  ``offsets`` of a call
    overrides the (E,) row offsets drawn from the runner's generator.
    ``mesh`` makes the step data parallel (the module's head).  On a CUDA
    runner every kernel runs on the card; on a CPU runner every wrapper runs
    its plain version."""
    return RnnMappoTrainStep(env, dims, cdims, cfg, deterministic_collect, mesh)
