"""IPPO on the fused kernels: the fused MLP collector (K2a), GAE, and the
PPO update through the whole-update-phase kernel (K3) or the per-pass
gradient kernel (K4) — the counterpart of ``rware_tpu/models/ippo_pallas.py``.
With message bits the collector runs its message mode (K2b), the dataset
carries the bits as a 7th entry and every pass takes K4 with the message head
then the optimizer step: K3 has no message head (``ippo_pallas.py:545-598``).

The collector already emits the common ``(T, B, N, ...)`` trajectory, so the
update reads it in place: minibatches are time windows ``(start + t) % T``
over all envs and agents, with a fresh random rotation per epoch drawn in
:func:`~rware_tpu_torch.ops.fused_update.phase_time_block` units (the
windows of the JAX package's fused path).  ``compute_gae_native`` of the JAX
package is :func:`~rware_tpu_torch.models.ippo.compute_gae` here.

With a :class:`~rware_tpu_torch.parallel.sharding.Mesh` the learner is data
parallel (``build_pallas_train_step(mesh=...)``): this rank collects its own
rows of the global batch (the collector keyed by their global indices), runs
GAE on them, and each pass's K4 gradients and metric sums leave as their mean
over the ranks (:func:`~rware_tpu_torch.parallel.sharding.data_parallel`);
K4 normalises the advantages over the window's rows of this shard, as JAX's
kernel does inside ``shard_map``.  K3 runs Adam inside the kernel, so it is
refused under a mesh.
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
    last_values,
    mean_metrics,
    optimizer_step,
    policy_obs_fn,
    policy_of,
    update_metrics,
)
from rware_tpu_torch.models.networks import BlockDims
from rware_tpu_torch.models.ppo import AdamState, clipped_ppo_terms, ppo_loss_native
from rware_tpu_torch.ops.fused_rollout import build_fused_collect
from rware_tpu_torch.ops.fused_update import (
    build_fused_ppo_grads,
    build_fused_ppo_update_phase,
    metric_means,
    phase_time_block,
)
from rware_tpu_torch.parallel.sharding import Mesh, data_parallel, refuse_under_mesh

# ippo_pallas.py:546-549 (and mappo.py:388-392 for K7)
WHOLE_PHASE_UNDER_MESH = ("the whole-phase kernel runs the optimizer in-kernel, so it is "
                          "incompatible with the per-minibatch gradient pmean of the mesh path")

__all__ = [
    "FusedTrainStep", "build_fused_train_step", "clipped_ppo_terms", "phase_window_starts",
    "ppo_loss_native", "ppo_update_epochs_native", "ppo_update_phase_fused",
]


def epoch_offsets(cfg: IPPOConfig, t_full: int, tb: int,
                  generator: torch.Generator) -> torch.Tensor:
    """(E,) per-epoch rotations, multiples of ``tb`` in [0, T)."""
    return torch.randint(0, t_full // tb, (cfg.epochs,), generator=generator) * tb


def phase_window_starts(cfg: IPPOConfig, t_full: int, tb: int,
                        generator: torch.Generator) -> torch.Tensor:
    """(P,) int64 window starts: per epoch a rotation, then M contiguous
    windows (``ippo_pallas.py:388-401``)."""
    mb_t = t_full // cfg.minibatches
    offs = epoch_offsets(cfg, t_full, tb, generator)
    m_idx = torch.arange(cfg.minibatches)
    return ((m_idx[None, :] * mb_t - offs[:, None]) % t_full).reshape(-1)


def ppo_update_epochs_native(cfg: IPPOConfig, params, opt_state: AdamState, dataset,
                             generator: torch.Generator, grads_fn,
                             starts: Optional[torch.Tensor] = None, step_fn=optimizer_step):
    """E epochs x M minibatches, one optimizer step per pass.

    ``grads_fn(params, dataset, start) -> (grads, sums)`` takes the full
    trajectory and a window start (:class:`FusedPPOGrads`); it normalises
    the advantages by each window's own mean and std.  In place of the (4,)
    metric sums it may return the metrics' means as a dict.  ``step_fn(cfg,
    params, grads, opt_state) -> (params, opt_state)`` is the optimizer
    step.  Returns ((params, opt_state), metrics)."""
    t_len = dataset[1].shape[0]
    if t_len % cfg.minibatches:
        raise ValueError(f"minibatches={cfg.minibatches} must divide rollout_len={t_len}")
    mb = t_len // cfg.minibatches
    if starts is None:
        starts = phase_window_starts(cfg, t_len, phase_time_block(mb), generator)
    n = mb * dataset[1].shape[1] * dataset[1].shape[2]
    per_pass = []
    for start in starts.tolist():
        grads, sums = grads_fn(params, dataset, start)
        params, opt_state = step_fn(cfg, params, grads, opt_state)
        per_pass.append(sums if isinstance(sums, dict) else metric_means(sums, n))
    return (params, opt_state), mean_metrics(per_pass)


def phase_advstats(adv: torch.Tensor, starts: torch.Tensor, mb_t: int) -> torch.Tensor:
    """(P, 2) [mean, 1/(std + 1e-8)] per window from per-time-row moments:
    ``E[x^2] - E[x]^2`` clamped at 0 (``ippo_pallas.py:426-435``)."""
    t_mean = adv.mean(dim=(1, 2))
    t_sqmean = (adv * adv).mean(dim=(1, 2))
    widx = (starts[:, None] + torch.arange(mb_t, device=adv.device)[None, :]) % adv.shape[0]
    w_mean = t_mean[widx].mean(dim=1)
    w_var = torch.clamp(t_sqmean[widx].mean(dim=1) - w_mean ** 2, min=0.0)
    return torch.stack([w_mean, 1.0 / (torch.sqrt(w_var) + 1e-8)], dim=1)


def ppo_update_phase_fused(cfg: IPPOConfig, params, opt_state: AdamState, dataset,
                           generator: torch.Generator, update_fn,
                           starts: Optional[torch.Tensor] = None):
    """The whole update phase through ``update_fn``
    (:class:`FusedPPOUpdatePhase`): window starts, advantage stats and Adam
    hyper rows are computed here, the kernel does the rest; the optimizer
    count advances by P.  Returns ((params, opt_state), metrics)."""
    action = dataset[1]
    dev = params.device
    t_full = action.shape[0]
    mb_t = t_full // cfg.minibatches
    n_passes = cfg.epochs * cfg.minibatches
    if starts is None:
        starts = phase_window_starts(cfg, t_full, update_fn.time_block, generator)
    starts = torch.as_tensor(starts, device=dev).to(torch.int64)
    advstats = phase_advstats(dataset[4], starts, mb_t)
    hyper = adam_hyper(cfg, opt_state.count, n_passes).to(dev)
    params, mu, nu, mets = update_fn(params, opt_state.mu, opt_state.nu, dataset, starts,
                                     advstats, hyper)
    n = mb_t * action.shape[1] * action.shape[2]
    metrics = {k: v.mean() for k, v in metric_means(mets, n).items()}
    return (params, AdamState(opt_state.count + n_passes, mu, nu)), metrics


class FusedTrainStep:
    """``train_step(runner, starts=None) -> (runner, metrics)``; see
    :func:`build_fused_train_step`.  The phases are methods so that callers
    can time them: :meth:`rollout`, :meth:`advantages`, :meth:`update`."""

    def __init__(self, env: Warehouse, dims: BlockDims, cfg: IPPOConfig,
                 deterministic_collect: bool = False,
                 fused_update_phase: Optional[bool] = None, mesh: Optional[Mesh] = None):
        if fused_update_phase is None:
            fused_update_phase = mesh is None
        if fused_update_phase and not dims.msg_bits:
            refuse_under_mesh(mesh, "the whole-update-phase kernel (K3)",
                              WHOLE_PHASE_UNDER_MESH)
        self.env, self.dims, self.cfg, self.mesh = env, dims, cfg, mesh
        self.env_offset = 0 if mesh is None else mesh.env_offset(cfg.n_envs)
        self.policy_obs = policy_obs_fn(env)
        self.collect = build_fused_collect(env.config, cfg.rollout_len, (dims.h1, dims.h2),
                                           deterministic=deterministic_collect)
        self.grads = build_fused_ppo_grads(dims, cfg.rollout_len // cfg.minibatches,
                                           cfg.clip_eps, cfg.vf_coef, cfg.ent_coef)
        self.update_phase = None
        if fused_update_phase and not dims.msg_bits:
            self.update_phase = build_fused_ppo_update_phase(
                dims, cfg.rollout_len, cfg.epochs, cfg.minibatches, cfg.clip_eps,
                cfg.vf_coef, cfg.ent_coef, cfg.max_grad_norm)
        self._policy = None

    def rollout(self, runner: RunnerState):
        """(env_states, traj) of one collector launch with this update's key."""
        self._policy = policy_of(self.dims, runner.params,
                                 None if self._policy is None
                                 else self._policy.to(runner.params.device))
        seed = collect_seed(runner.seed, runner.update_idx)
        return self.collect(runner.env_states, self._policy, seed, self.env_offset)

    def advantages(self, runner: RunnerState, env_states, traj: Dict[str, torch.Tensor]):
        """(obs after the rollout, advantages, targets)."""
        obs = self.policy_obs(env_states)
        adv, targets = compute_gae(self.cfg, traj["reward"], traj["value"], traj["done"],
                                   last_values(self.dims, runner.params, obs))
        return obs, adv, targets

    def update(self, runner: RunnerState, dataset, starts: Optional[torch.Tensor] = None):
        """((params, opt_state), metrics) of the E x M update passes."""
        if self.update_phase is not None:
            return ppo_update_phase_fused(self.cfg, runner.params, runner.opt_state, dataset,
                                          runner.generator, self.update_phase, starts)
        return ppo_update_epochs_native(self.cfg, runner.params, runner.opt_state, dataset,
                                        runner.generator, data_parallel(self.grads, self.mesh),
                                        starts)

    def __call__(self, runner: RunnerState, starts: Optional[torch.Tensor] = None
                 ) -> Tuple[RunnerState, dict]:
        env_states, traj = self.rollout(runner)
        obs, adv, targets = self.advantages(runner, env_states, traj)
        dataset = (traj["obs"], traj["action"], traj["logp"], traj["value"], adv, targets)
        if "bits" in traj:
            dataset += (traj["bits"],)
        (params, opt_state), ppo = self.update(runner, dataset, starts)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, ppo, self.mesh)


def build_fused_train_step(env: Warehouse, dims: BlockDims, cfg: IPPOConfig,
                           deterministic_collect: bool = False,
                           fused_update_phase: Optional[bool] = None,
                           mesh: Optional[Mesh] = None) -> FusedTrainStep:
    """The fused learner (``build_pallas_train_step`` with ``native=True``,
    ``ippo_pallas.py:488-598``): K2a collect, GAE, then the update phase.

    ``fused_update_phase`` (the default without a mesh) runs all E x M
    passes in the K3 kernel; otherwise, and always with message bits, each
    pass takes the K4 gradient, then the optimizer step.  ``mesh`` makes the
    step data parallel over the mesh's ranks (the module's head): the runner
    holds this rank's envs, ``cfg.n_envs`` is the global batch, and asking
    for K3 raises.
    ``starts`` of a call overrides the (P,) window starts drawn from the
    runner's generator.  On a CUDA runner every kernel runs on
    the card; on a CPU runner every wrapper runs its plain version."""
    return FusedTrainStep(env, dims, cfg, deterministic_collect, fused_update_phase, mesh)
