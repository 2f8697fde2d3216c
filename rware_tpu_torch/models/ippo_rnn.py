"""Recurrent IPPO: GRU policies over partial observations (the counterpart
of ``rware_tpu/models/ippo_rnn.py``).  With message bits the collector runs
its message mode (K2b), the dataset carries the bits as a 9th entry and the
loss is that of the joint move + Bernoulli policy (``ippo_rnn.py:574-597``);
the heads, message head included, stay autograd around K9 and K10.

The GRU carry ``(B, N, Hg)`` bf16 lives in the runner next to the env states;
an episode's end zeroes it.  The PPO epochs keep whole sequences: a minibatch
is a set of envs, and the GRU is run again over the stored trajectory from
the carry at the rollout's start.

* :func:`build_rnn_train_step` is the plain learner
  (``ippo_rnn.py:79-245``): the plain version of the recurrent collector,
  env-shuffled minibatches, a per-step replay under autograd.
* :func:`build_rnn_fused_train_step` is the learner on the kernels
  (``build_rnn_pallas_train_step`` with ``native=True, fused_loss=False``,
  ``ippo_rnn.py:745-937``): the recurrent collector (K2c), then E epochs of M
  **env-band** minibatches, each one launch of the GRU forward kernel (K9)
  and one of its backward kernel (K10) around the head product and the loss,
  which autograd differentiates as XLA does there.  With ``fused_loss=True``
  (JAX's ``fused_loss``, ``ippo_rnn.py:879-893``) each pass is
  :func:`rnn_fused_grads` instead: the embed and input gates by torch
  products, the recurrence by K11 and the loss-fused backward by K13.

Parameters are one flat float32 vector in the
:class:`~rware_tpu_torch.models.networks.GruDims` layout, so the optimizer of
:mod:`rware_tpu_torch.models.ppo` serves unchanged.

With a :class:`~rware_tpu_torch.parallel.sharding.Mesh` the fused learner is
data parallel (``build_rnn_pallas_train_step(mesh=...)``): K2c collects this
rank's rows keyed by their global indices, the band plan is the shard's
(``rb = n_local / LANE``, ``ippo_rnn.py:826``), each band normalises its
advantages over its own envs, and each pass's gradients and metrics leave
as their mean over the ranks.  The plain learner takes a mesh too, as JAX only
places its step on one (``train.py:291-303``): every minibatch of envs is the
whole batch's, its statistics and gradients summed over the ranks
(:mod:`rware_tpu_torch.parallel.sharding`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.models.ippo import (
    IPPOConfig,
    collect_seed,
    compute_gae,
    mean_metrics,
    optimizer_init,
    optimizer_step,
    policy_obs_fn,
    reset_envs,
    reward_sums,
    update_metrics,
)
from rware_tpu_torch.models.networks import (
    GruDims,
    arrays_to_gru,
    gru_apply_step,
    gru_embed_gates,
    gru_replay_heads,
    gru_replay_step,
    gru_to_arrays,
    init_recurrent_actor_critic,
    pack_arrays,
    rnd_bf16,
    round_grad_blocks,
)
from rware_tpu_torch.models.ppo import AdamState, clipped_ppo_terms, loss_grads
from rware_tpu_torch.ops.fused_gru import (
    GruObsScan,
    build_fused_gru_loss_bwd,
    build_fused_gru_obs_bwd,
    build_fused_gru_obs_fwd,
    build_fused_gru_seq_fwd,
)
from rware_tpu_torch.ops.fused_rollout import build_fused_collect_gru
from rware_tpu_torch.parallel.sharding import Mesh, data_parallel

LANE = 128  # envs per row of a band (the JAX package's tile width)
HEAD_BLOCK = 6  # Wc in the GruDims layout: the replay casts it to bf16 (gru_replay_heads)


@dataclasses.dataclass
class RNNRunnerState:
    """Everything the recurrent train loop carries between updates.
    ``generator`` (a CPU ``torch.Generator``) is advanced in place."""

    params: torch.Tensor  # flat float32, GruDims layout
    opt_state: AdamState
    env_states: WarehouseState  # env-batched (B, ...)
    obs: torch.Tensor  # (B, N, L)
    carry: torch.Tensor  # (B, N, Hg) bf16 GRU hidden
    generator: torch.Generator
    update_idx: int
    seed: int  # the run seed: keys the collector's streams (collect_seed)


def init_rnn_runner(env: Warehouse, cfg: IPPOConfig, seed: int, hidden: int = 128,
                    embed: int = 128, mesh: Optional[Mesh] = None
                    ) -> Tuple[RNNRunnerState, GruDims]:
    """Parameters (flax's default init, from ``seed``), optimizer, a fresh
    batch of ``cfg.n_envs`` env states and the zero carry on ``env.device``
    (with a mesh this rank's rows, :func:`~rware_tpu_torch.models.ippo.reset_envs`)."""
    model = init_recurrent_actor_critic(env.config.policy_obs_length, env.n_actions, hidden,
                                        embed, seed, env.config.msg_bits)
    params = pack_arrays(gru_to_arrays(model)).detach().to(env.device)
    env_states = reset_envs(env, seed, cfg.n_envs, mesh)
    obs = policy_obs_fn(env)(env_states)
    runner = RNNRunnerState(
        params=params, opt_state=optimizer_init(params), env_states=env_states, obs=obs,
        carry=model.initialize_carry((env_states.batch_size, env.n_agents), env.device),
        generator=torch.Generator().manual_seed(seed), update_idx=0, seed=seed,
    )
    return runner, GruDims.of(model)


def rnn_policy_of(dims: GruDims, params: torch.Tensor, model=None):
    """The :class:`RecurrentActorCritic` holding ``params`` (copied into
    ``model`` when given) — what the collectors run."""
    return arrays_to_gru(dims.split(params.detach()), model, dims.msg_bits)


def rnn_last_values(dims: GruDims, params: torch.Tensor, carry: torch.Tensor,
                    obs: torch.Tensor) -> torch.Tensor:
    """(B, N) values of the observations after the rollout from the carry
    after it, by the JAX package's ``model.apply`` recipe
    (:func:`gru_apply_step`; ``ippo_rnn.py:823-825``)."""
    with torch.no_grad():
        return gru_apply_step(dims.split(params), carry, obs, dims.msg_bits)[2]


def band_slice(x: torch.Tensor, start_env: int, n_env: int) -> torch.Tensor:
    """Envs ``(start_env + i) % B``, ``i < n_env``, of a (T, B, ...) tensor:
    a view unless the band wraps."""
    b = x.shape[1]
    if start_env + n_env <= b:
        return x[:, start_env:start_env + n_env]
    return torch.cat([x[:, start_env:], x[:, :start_env + n_env - b]], dim=1)


def gru_native_replay(dims: GruDims, params: torch.Tensor, obs, done, h0, start_env: int,
                      n_env: int, fwd, bwd):
    """(logits (T, n_env, N, A), value (T, n_env, N)) of the GRU run again
    over an env band of the stored trajectory (``_gru_native_replay``,
    ``ippo_rnn.py:473-560``): the hidden sequence by :class:`GruObsScan`
    (K9, and K10 on the way back), then the head product on the bf16 hidden
    with bf16-rounded head weights and float32 sums; with message bits the
    logits are ``(logits, msg_logits)``."""
    we, be, wi, bi, wh, bhn, wc, bc = dims.split(params)
    hseq = GruObsScan.apply(we, be, wi, bi, wh, bhn, obs, done, h0, start_env, n_env, fwd, bwd)
    return gru_replay_heads(wc, bc, hseq, dims.msg_bits)


def rnn_ppo_loss_native(cfg, dims: GruDims, params: torch.Tensor, dataset, band, fwd, bwd):
    """Clipped-PPO loss of one env band ``(start_env, n_env)`` of the dataset
    ``(obs, done, action, logp, value, adv, target, h0)`` in the ``(T, B, N,
    ...)`` layout, and the bits (T, B, N, M) as a 9th entry with message bits
    (``ippo_rnn.py:574-597``); the advantages are normalised over the band.
    Returns (total, metrics)."""
    obs, done, action, logp, value_old, adv, target, h0 = dataset[:8]
    heads, value = gru_native_replay(dims, params, obs, done, h0, *band, fwd, bwd)
    bits = band_slice(dataset[8], *band) if dims.msg_bits else None
    action, logp, value_old, adv, target = (
        band_slice(x, *band) for x in (action, logp, value_old, adv, target))
    return clipped_ppo_terms(cfg, heads, value, action, logp, value_old, adv, target, bits=bits)


FUSED_LOSS_NO_BITS = ("the loss-fused recurrent update takes no message bits: JAX takes it only "
                      "for 8-entry batches (ippo_rnn.py:879-880) and K13 has no message head")


def rnn_fused_grads(cfg, dims: GruDims, params: torch.Tensor, dataset, band, fwd, loss_bwd):
    """Hand-derived gradients of :func:`rnn_ppo_loss_native` on one env band
    ``(start_env, n_env)`` (``rnn_fused_grads``, ``ippo_rnn.py:610-742``):
    the embed and the fused input gates ``iall`` by torch products, rounded
    to bf16 before the recurrence; the hidden sequence by ``fwd`` (K11); the
    f32 heads ``[W_policy | W_value]``, the loss and the GRU's reverse sweep
    by ``loss_bwd`` (K13), with the band's advantage mean and 1 / (std +
    1e-8); then the three input-side products (dWi, de, dWe).  The products
    multiply bf16 values as float32 with float32 sums, as JAX's
    ``preferred_element_type=float32``.  ``dataset`` as for
    :func:`rnn_ppo_loss_native`, without bits.  Returns (flat float32
    gradient, metrics)."""
    if dims.msg_bits:
        raise ValueError(FUSED_LOSS_NO_BITS)
    obs, done, action, logp, value_old, adv, target, h0 = dataset[:8]
    start, n_env = band
    with torch.no_grad():
        we, be, wi, bi, wh, bhn, wc, bc = dims.split(params.detach())
        x = band_slice(obs, start, n_env).float()
        e, iall = gru_embed_gates((we, be, wi, bi), x)
        iall = iall.to(torch.bfloat16)
        hseq = fwd(wh, bhn, iall, done, h0, start, n_env)
        advb = band_slice(adv, start, n_env)
        stats = torch.stack([advb.mean(), 1.0 / (advb.std(correction=0) + 1e-8)])
        d_iall, dwh, dbhn, dwhead, dbhead, _, mets = loss_bwd(
            wh, bhn, wc, bc[0], iall, done, h0, hseq, action, logp, value_old, adv, target,
            stats, start, n_env)
        e2 = e.reshape(-1, dims.embed)
        dg2 = d_iall.float().reshape(-1, 3 * dims.hidden)
        dwi, dbi = e2.t() @ dg2, dg2.sum(0)
        dpre = rnd_bf16((dg2 @ rnd_bf16(wi).t()) * (1.0 - e2 * e2))
        dwe, dbe = x.reshape(-1, dims.obs_len).t() @ dpre, dpre.sum(0)
        grads = torch.cat([g.reshape(-1) for g in (dwe, dbe, dwi, dbi, dwh, dbhn, dwhead,
                                                   dbhead)])
        inv_n = 1.0 / hseq[..., 0].numel()
        metrics = {"pg_loss": -mets[0] * inv_n, "v_loss": mets[1] * inv_n,
                   "entropy": mets[2] * inv_n, "approx_kl": mets[3] * inv_n}
    return grads, metrics


def band_rows(cfg: IPPOConfig) -> Tuple[int, int]:
    """(envs per row, rows) of the env bands: rows of :data:`LANE` envs, M
    dividing their number (``ippo_rnn.py:849-854``).  A batch that small
    that it has fewer than M such rows (the JAX collector cannot run one: it
    takes multiples of 1,024 envs) is cut in rows of B / M envs."""
    b, m = cfg.n_envs, cfg.minibatches
    if b % (LANE * m) == 0:
        return LANE, b // LANE
    if b < LANE * m and b % m == 0:
        return b // m, m
    raise ValueError(f"minibatches={m} must divide the {b // LANE} env rows (n_envs / {LANE})")


def epoch_band_starts(cfg: IPPOConfig, off: int) -> Tuple[int, list]:
    """(envs per band, the M bands' first envs) of an epoch with row offset
    ``off``: pass i takes rows ``(i * mb - off) % rb`` onwards, wrapping
    (``ippo_rnn.py:870-878``)."""
    lane, rb = band_rows(cfg)
    mb = rb // cfg.minibatches
    return mb * lane, [((i * mb - off) % rb) * lane for i in range(cfg.minibatches)]


def band_passes(cfg: IPPOConfig, runner: RNNRunnerState, offsets: Optional[torch.Tensor],
                grads_fn, step_fn):
    """((params, opt_state), metrics) of the E x M env-band passes from the
    runner's parameters and optimizer state: per epoch one row offset in
    ``[0, rb)`` (``offsets``, else drawn from the runner's generator) and M
    bands (:func:`epoch_band_starts`), each ``grads_fn(params, (start_env,
    n_env)) -> (grads, metrics)`` and then ``step_fn(cfg, params, grads,
    opt_state)``."""
    if offsets is None:
        offsets = torch.randint(0, band_rows(cfg)[1], (cfg.epochs,), generator=runner.generator)
    params, opt_state = runner.params, runner.opt_state
    per_pass = []
    for off in torch.as_tensor(offsets).tolist():
        n_env, starts = epoch_band_starts(cfg, int(off))
        for start in starts:
            grads, metrics = grads_fn(params, (start, n_env))
            params, opt_state = step_fn(cfg, params, grads, opt_state)
            per_pass.append(metrics)
    return (params, opt_state), mean_metrics(per_pass)


class RnnFusedTrainStep:
    """``train_step(runner, offsets=None) -> (runner, metrics)``; see
    :func:`build_rnn_fused_train_step`.  The phases are methods so that
    callers can time them: :meth:`rollout`, :meth:`advantages`,
    :meth:`band_grads`, :meth:`update`."""

    def __init__(self, env: Warehouse, dims: GruDims, cfg: IPPOConfig,
                 deterministic_collect: bool = False, fused_loss: bool = False,
                 mesh: Optional[Mesh] = None):
        self.env_offset = 0 if mesh is None else mesh.env_offset(cfg.n_envs)
        n_local = cfg.n_envs if mesh is None else mesh.n_local(cfg.n_envs)
        # the band plan of this rank's envs (ippo_rnn.py:826, rb = n_local // LANE)
        self.local_cfg = dataclasses.replace(cfg, n_envs=n_local)
        band_rows(self.local_cfg)
        if fused_loss and dims.msg_bits:
            raise ValueError(FUSED_LOSS_NO_BITS)
        self.env, self.dims, self.cfg, self.mesh = env, dims, cfg, mesh
        self.fused_loss = fused_loss
        self.policy_obs = policy_obs_fn(env)
        self.collect = build_fused_collect_gru(env.config, cfg.rollout_len,
                                               (dims.embed, dims.hidden),
                                               deterministic=deterministic_collect)
        self.gru_fwd = build_fused_gru_obs_fwd(dims)
        self.gru_bwd = build_fused_gru_obs_bwd(dims)
        self.seq_fwd = self.loss_bwd = None
        if fused_loss:
            self.seq_fwd = build_fused_gru_seq_fwd(dims)
            self.loss_bwd = build_fused_gru_loss_bwd(dims, cfg.clip_eps, cfg.vf_coef,
                                                     cfg.ent_coef)
        self._policy = None

    def rollout(self, runner: RNNRunnerState):
        """(env_states, new_carry, traj) of one collector launch from the
        runner's carry with this update's key."""
        self._policy = rnn_policy_of(self.dims, runner.params,
                                     None if self._policy is None
                                     else self._policy.to(runner.params.device))
        seed = collect_seed(runner.seed, runner.update_idx)
        return self.collect(runner.env_states, self._policy, seed, runner.carry, self.env_offset)

    def advantages(self, runner: RNNRunnerState, env_states, new_carry,
                   traj: Dict[str, torch.Tensor]):
        """(obs after the rollout, advantages, targets)."""
        obs = self.policy_obs(env_states)
        last = rnn_last_values(self.dims, runner.params, new_carry, obs)
        adv, targets = compute_gae(self.cfg, traj["reward"], traj["value"], traj["done"], last)
        return obs, adv, targets

    def band_grads(self, params: torch.Tensor, dataset, band):
        """(flat gradient, metrics) of one env band ``(start_env, n_env)``:
        autograd of the loss around one K9 and one K10 launch, or with
        ``fused_loss`` :func:`rnn_fused_grads` (one K11 and one K13)."""
        if self.fused_loss:
            return rnn_fused_grads(self.cfg, self.dims, params, dataset, band, self.seq_fwd,
                                   self.loss_bwd)
        return loss_grads(lambda p: rnn_ppo_loss_native(self.cfg, self.dims, p, dataset, band,
                                                        self.gru_fwd, self.gru_bwd), params)

    def update(self, runner: RNNRunnerState, dataset, offsets: Optional[torch.Tensor] = None):
        """((params, opt_state), metrics) of the E x M band passes
        (:func:`band_passes`): :meth:`band_grads` (with a mesh, its mean over
        the ranks) and one optimizer step each."""
        grads_fn = data_parallel(lambda p, band: self.band_grads(p, dataset, band), self.mesh)
        return band_passes(self.local_cfg, runner, offsets, grads_fn, optimizer_step)

    def __call__(self, runner: RNNRunnerState, offsets: Optional[torch.Tensor] = None
                 ) -> Tuple[RNNRunnerState, dict]:
        env_states, new_carry, traj = self.rollout(runner)
        obs, adv, targets = self.advantages(runner, env_states, new_carry, traj)
        dataset = (traj["obs"], traj["done"], traj["action"], traj["logp"], traj["value"], adv,
                   targets, runner.carry)
        if "bits" in traj:
            dataset += (traj["bits"],)
        (params, opt_state), ppo = self.update(runner, dataset, offsets)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs, carry=new_carry,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, ppo, self.mesh)


def build_rnn_fused_train_step(env: Warehouse, dims: GruDims, cfg: IPPOConfig,
                               deterministic_collect: bool = False,
                               fused_loss: bool = False,
                               mesh: Optional[Mesh] = None) -> RnnFusedTrainStep:
    """The recurrent learner on the kernels: K2c collect from the runner's
    carry, the bootstrap value by the flax-rounding forward on the new carry,
    GAE, then per epoch one row offset in ``[0, rb)`` and M env-band passes
    (:func:`epoch_band_starts`), each a K9 forward, the loss, a K10 backward
    and one clip + Adam step.  ``fused_loss`` takes each pass's gradient from
    :func:`rnn_fused_grads` (K11 and K13) instead, as
    ``build_rnn_pallas_train_step(fused_loss=True)``; with message bits it
    raises, since JAX then takes the default path.  ``offsets`` of a call
    overrides the (E,) row offsets drawn from the runner's generator.
    ``mesh`` makes the step data parallel (the module's head): the runner
    holds this rank's envs and ``cfg.n_envs`` is the global batch.  On a
    CUDA runner every kernel runs on the card; on a CPU runner every wrapper
    runs its plain version."""
    return RnnFusedTrainStep(env, dims, cfg, deterministic_collect, fused_loss, mesh)


class RnnPlainTrainStep:
    """``train_step(runner, draws=None) -> (runner, metrics)``; see
    :func:`build_rnn_train_step`.  The phases are methods so that callers
    can time them: :meth:`rollout`, :meth:`advantages`, :meth:`update`."""

    def __init__(self, env: Warehouse, dims: GruDims, cfg: IPPOConfig,
                 mesh: Optional[Mesh] = None):
        self.env_offset = 0 if mesh is None else mesh.env_offset(cfg.n_envs)
        self.env, self.dims, self.cfg, self.mesh = env, dims, cfg, mesh
        self.collect = build_fused_collect_gru(env.config, cfg.rollout_len,
                                               (dims.embed, dims.hidden))
        self.model = rnn_policy_of(dims, torch.zeros(dims.n_params))
        self.obs_fn = policy_obs_fn(env)

    def rollout(self, runner: RNNRunnerState):
        """(env_states, new_carry, traj) of the recurrent collector's plain
        version from the runner's carry with this update's key, on this
        rank's envs at their global indices."""
        policy = rnn_policy_of(self.dims, runner.params, self.model.to(runner.params.device))
        seed = collect_seed(runner.seed, runner.update_idx)
        return self.collect.plain(runner.env_states, policy, seed, runner.carry,
                                  self.env_offset)

    def advantages(self, runner: RNNRunnerState, env_states, new_carry, traj):
        """(obs after the rollout, advantages, targets)."""
        obs = self.obs_fn(env_states)
        adv, targets = compute_gae(self.cfg, traj["reward"], traj["value"], traj["done"],
                                   rnn_last_values(self.dims, runner.params, new_carry, obs))
        return obs, adv, targets

    def loss(self, params, traj, adv, targets, h0, idx, advstats, count):
        """The per-step replay (:func:`gru_replay_step`) of the envs ``idx``
        from their carry ``h0[idx]`` and the clipped-PPO loss on them, a
        partial sum over ``count``; the head weights' gradient stays float32
        (:meth:`update` rounds the whole sum's)."""
        dims, t_len = self.dims, traj["done"].shape[0]
        arrays = dims.split(params)
        h = h0[idx].float()
        hseq = []
        for t in range(t_len):
            new_h = gru_replay_step(arrays[:6], h, traj["obs"][t, idx])
            hseq.append(new_h)
            h = torch.where(traj["done"][t, idx][:, None, None], torch.zeros_like(new_h), new_h)
        heads, value = gru_replay_heads(arrays[6], arrays[7], torch.stack(hseq), dims.msg_bits,
                                        round_grads=False)
        bits = traj["bits"][:, idx] if dims.msg_bits else None
        return clipped_ppo_terms(self.cfg, heads, value, traj["action"][:, idx],
                                 traj["logp"][:, idx], traj["value"][:, idx], adv[:, idx],
                                 targets[:, idx], advstats, bits, count)

    def update(self, runner: RNNRunnerState, traj, adv, targets, draws=None):
        """((params, opt_state), metrics, (reward sum, episodes)) of E epochs
        of M minibatches of envs: per epoch a permutation of the whole
        batch's B envs (``draws``, else drawn from the runner's generator,
        the same on every rank), M slices of B / M envs, this rank's envs of
        each replayed from their carry; every minibatch's statistics and the
        reward sums in one float64 all-reduce, each pass's gradients and
        metrics summed over the ranks (``ippo_rnn.py:198-220``)."""
        from rware_tpu_torch.parallel.sharding import rank_rows, row_moments, whole_batch_stats

        cfg, mesh = self.cfg, self.mesh
        mb = cfg.n_envs // cfg.minibatches
        if draws is None:
            draws = [torch.randperm(cfg.n_envs, generator=runner.generator)
                     for _ in range(cfg.epochs)]
        passes = [rank_rows(idx, cfg.n_envs, mesh) for perm in draws for idx in
                  torch.as_tensor(perm, dtype=torch.int64)[:mb * cfg.minibatches]
                  .reshape(cfg.minibatches, mb)]
        advstats, counts, sums = whole_batch_stats(row_moments(adv, 1), passes,
                                                   reward_sums(traj), mesh)
        grads_fn = data_parallel(
            lambda p, idx, stats, n: loss_grads(
                lambda q: self.loss(q, traj, adv, targets, runner.carry, idx, stats, n), p),
            mesh, "sum")
        params, opt_state = runner.params, runner.opt_state
        per_pass = []
        for idx, stats, n in zip(passes, advstats, counts):
            grads, metrics = grads_fn(params, idx.to(params.device), stats, n)
            grads = round_grad_blocks(self.dims, grads, (HEAD_BLOCK,))  # the whole sum's
            params, opt_state = optimizer_step(cfg, params, grads, opt_state)
            per_pass.append(metrics)
        return (params, opt_state), mean_metrics(per_pass), sums

    def __call__(self, runner: RNNRunnerState, draws=None) -> Tuple[RNNRunnerState, dict]:
        env_states, new_carry, traj = self.rollout(runner)
        obs, adv, targets = self.advantages(runner, env_states, new_carry, traj)
        (params, opt_state), ppo, sums = self.update(runner, traj, adv, targets, draws)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs, carry=new_carry,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, ppo, sums=sums)


def build_rnn_train_step(env: Warehouse, dims: GruDims, cfg: IPPOConfig,
                         mesh: Optional[Mesh] = None) -> RnnPlainTrainStep:
    """The plain recurrent learner: ``train_step(runner, draws=None) ->
    (runner, metrics)``.  Collects with the plain version of the recurrent
    collector (Philox draws keyed by :func:`collect_seed`, the carry zeroed
    at episode ends), then GAE and E epochs of M minibatches of shuffled
    envs, each the per-step replay (:func:`gru_replay_step`) from the carry
    at the rollout's start, under autograd, its advantages normalised over
    the minibatch.  ``draws`` of a call gives the update's E permutations of
    the envs.  ``mesh`` makes it data parallel with the whole batch's
    statistics, as JAX's step placed on a device mesh (``train.py:291-303``):
    the runner holds this rank's envs, ``cfg.n_envs`` is the global batch,
    and every pass's gradient is the one-rank gradient of the whole
    minibatch."""
    return RnnPlainTrainStep(env, dims, cfg, mesh)
