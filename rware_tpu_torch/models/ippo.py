"""IPPO: independent PPO with parameter sharing (the counterpart of
``rware_tpu/models/ippo.py``).

The learner carries its parameters as one flat float32 vector in the kernel
layout of :class:`~rware_tpu_torch.models.networks.BlockDims` (the six
blocks of ``ippo_pallas._params_to_arrays``), and its optimizer state as
flat Adam moments of the same layout, so the plain learner here, the
per-pass learner and the whole-update-phase kernel of
:mod:`rware_tpu_torch.models.ippo_fused` share one representation.

The loss and the optimizer step are those of
:mod:`rware_tpu_torch.models.ppo`.  Every random choice (minibatch permutations, epoch
rotations) comes from the runner's ``torch.Generator``; the collector's
random stream is keyed by :func:`collect_seed`.  The plain learner takes a
:class:`~rware_tpu_torch.parallel.sharding.Mesh` with the whole batch's
statistics, as JAX only places its step on a mesh (``train.py:291-303``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from rware_tpu_torch.core.engine import build_policy_obs_fn
from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.models.networks import (
    DENSE_CAST_BLOCKS,
    BlockDims,
    apply_forward,
    arrays_to_params,
    init_actor_critic,
    pack_arrays,
    params_to_arrays,
    round_grad_blocks,
)
from rware_tpu_torch.models.ppo import (
    ADAM_B1,
    ADAM_B2,
    METRIC_KEYS,
    AdamState,
    clip_adam,
    clipped_ppo_terms,
    loss_grads,
)


@dataclasses.dataclass(frozen=True)
class IPPOConfig:
    """Ported copy of ``rware_tpu.models.ippo.IPPOConfig``."""

    n_envs: int = 1024
    rollout_len: int = 128
    epochs: int = 4
    minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    anneal_lr: bool = False
    total_updates: int = 1000  # for lr annealing
    # "shuffle": random-permutation minibatches; "block": a random per-epoch
    # offset then contiguous slices (time-bands over all envs)
    minibatch_mode: str = "shuffle"


@dataclasses.dataclass
class RunnerState:
    """Everything the train loop carries between updates.  ``generator``
    (a CPU ``torch.Generator``) is advanced in place by every update."""

    params: torch.Tensor  # flat float32, BlockDims layout
    opt_state: AdamState
    env_states: WarehouseState  # env-batched (B, ...)
    obs: torch.Tensor  # (B, N, L)
    generator: torch.Generator
    update_idx: int
    seed: int  # the run seed: keys the collector's streams (collect_seed)


class Transition(NamedTuple):
    obs: torch.Tensor  # (T, B, N, L) bf16
    action: torch.Tensor  # (T, B, N) int32
    logp: torch.Tensor  # (T, B, N)
    value: torch.Tensor  # (T, B, N)
    reward: torch.Tensor  # (T, B, N)
    done: torch.Tensor  # (T, B) bool


def policy_obs_fn(env: Warehouse) -> Callable[[WarehouseState], torch.Tensor]:
    """``obs(states) -> (B, N, L)`` flat observations for the MLP and GRU
    learners, L = ``config.policy_obs_length`` (the counterpart of
    ``rware_tpu/models/ippo.py::policy_obs_fn``): FLATTENED and DICT pass
    through, IMAGE flattens the (C, w, w) window stack, IMAGE_DICT appends
    the 6 self features [dir-onehot(4), on_highway, carrying]."""
    return build_policy_obs_fn(env.config, env._obs_fn)


def collect_seed(run_seed: int, update_idx: int) -> int:
    """The collector's 64-bit Philox key of one update: ``(run_seed << 32) |
    update_idx``.  Keys never repeat within a run or across runs with other
    seeds, so every update draws from its own streams
    (``ippo_pallas.py:533-542``)."""
    if not 0 <= run_seed < 2**32 or not 0 <= update_idx < 2**32:
        raise ValueError("run seed and update index must be in [0, 2**32)")
    return (run_seed << 32) | update_idx


def compute_gae(cfg: IPPOConfig, rewards, values, dones, last_value):
    """GAE over a (T, B, N) trajectory with (T, B) done masks; returns
    (advantages, targets)."""
    g = torch.zeros_like(last_value)
    next_v = last_value
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        not_done = 1.0 - dones[t].to(torch.float32)[:, None]
        delta = rewards[t] + cfg.gamma * next_v * not_done - values[t]
        g = delta + cfg.gamma * cfg.gae_lambda * not_done * g
        next_v = values[t]
        out.append(g)
    advantages = torch.stack(out[::-1])
    return advantages, advantages + values


def ppo_loss(cfg: IPPOConfig, dims: BlockDims, params: torch.Tensor, batch,
             advstats: Optional[torch.Tensor] = None, count: Optional[torch.Tensor] = None):
    """Clipped-PPO loss on a flat (M, N, ...) minibatch
    ``(obs, action, old_logp, old_value, adv, target)``, and the bits (M, N,
    M_bits) as a 7th entry where ``dims`` has message bits; ``advstats`` and
    ``count`` as in :func:`clipped_ppo_terms` (a rank's part of a whole
    minibatch).  The network is JAX's ``model.apply`` in flax's rounding
    (:func:`apply_forward`, as ``ippo.py:127``); the hidden weights' and
    biases' gradients are float32 sums, which :func:`ppo_update_epochs`
    rounds to bf16 once the whole minibatch's sum is taken."""
    obs, action, old_logp, old_value, adv, target = batch[:6]
    heads, value = apply_forward(dims.split(params), obs, dims.msg_bits)
    return clipped_ppo_terms(cfg, heads, value, action, old_logp, old_value, adv, target,
                             advstats, batch[6] if dims.msg_bits else None, count)


def make_lr_schedule(cfg: IPPOConfig) -> Callable[[int], torch.Tensor]:
    """The per-step learning rate as a function of the optimizer count, in
    float32: optax ``linear_schedule(lr, 0, total_updates * E * M)`` when
    annealing, else constant."""
    lr = torch.tensor(cfg.lr, dtype=torch.float32)
    if not cfg.anneal_lr:
        return lambda count: lr
    steps = cfg.total_updates * cfg.epochs * cfg.minibatches

    def schedule(count: int) -> torch.Tensor:
        c = torch.tensor(min(max(count, 0), steps), dtype=torch.float32)
        frac = 1.0 - c / steps
        return lr * frac

    return schedule


def adam_hyper(cfg: IPPOConfig, count: int, n: int) -> torch.Tensor:
    """(n, 3) float32 rows [lr_t, 1/(1-b1^t), 1/(1-b2^t)] of the next ``n``
    optimizer steps after ``count`` (``ippo_pallas.py:437-451``)."""
    sched = make_lr_schedule(cfg)
    t = torch.arange(count + 1, count + n + 1, dtype=torch.float32)
    lr = torch.stack([sched(count + q) for q in range(n)])
    bc1 = 1.0 / (1.0 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32), t))
    bc2 = 1.0 / (1.0 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32), t))
    return torch.stack([lr, bc1, bc2], dim=1)


def optimizer_init(params: torch.Tensor) -> AdamState:
    return AdamState(0, torch.zeros_like(params), torch.zeros_like(params))


def optimizer_step(cfg: IPPOConfig, params, grads, opt_state: AdamState):
    """``optax.chain(clip_by_global_norm, adam(schedule, eps=1e-5))`` on flat
    tensors; returns (params, opt_state)."""
    hyper = adam_hyper(cfg, opt_state.count, 1)[0].to(params.device)
    params, mu, nu = clip_adam(params, grads, opt_state.mu, opt_state.nu, hyper,
                               cfg.max_grad_norm)
    return params, AdamState(opt_state.count + 1, mu, nu)


def mean_metrics(per_pass) -> Dict[str, torch.Tensor]:
    """Means over passes of a list of metric dicts."""
    return {k: torch.stack([m[k] for m in per_pass]).mean() for k in METRIC_KEYS}


def minibatch_rows(cfg: IPPOConfig, n_data: int, generator: torch.Generator,
                   draws=None) -> List[torch.Tensor]:
    """The E x M minibatches of an update as global row indices into the
    ``n_data`` rows (``ippo.py:186-223``): per epoch a permutation
    (``shuffle``; its first M * mb entries, M slices) or an offset in [0,
    n_data) (``block``: the rows rolled by it, M contiguous slices).
    ``draws`` holds the E permutations or offsets; None draws them from
    ``generator``, the same on every rank."""
    e, m = cfg.epochs, cfg.minibatches
    mb = n_data // m
    if cfg.minibatch_mode == "shuffle":
        if draws is None:
            draws = [torch.randperm(n_data, generator=generator) for _ in range(e)]
        return [r for perm in draws
                for r in torch.as_tensor(perm, dtype=torch.int64)[:mb * m].reshape(m, mb)]
    if cfg.minibatch_mode == "block":
        if draws is None:
            draws = [int(torch.randint(0, n_data, (), generator=generator)) for _ in range(e)]
        return [(torch.arange(mb) + i * mb - int(off)) % n_data
                for off in draws for i in range(m)]
    raise ValueError(f"unknown minibatch_mode {cfg.minibatch_mode!r}")


def ppo_update_epochs(cfg: IPPOConfig, dims: BlockDims, params, opt_state, dataset, passes,
                      advstats, counts, mesh=None):
    """E epochs x M minibatches of SGD over a flat dataset tuple (leading
    axis T*B, this rank's rows): pass p takes the rows ``passes[p]`` (this
    rank's part of the p-th whole minibatch, maybe none), normalised by
    ``advstats[p]``, its loss a partial sum over ``counts[p]``; with a mesh
    its gradients and metrics are summed over the ranks, and the hidden
    layers' gradients rounded to bf16 (JAX's cast, :func:`round_grad_blocks`).
    Returns ((params, opt_state), per-pass metric dicts)."""
    from rware_tpu_torch.parallel.sharding import data_parallel

    grads_fn = data_parallel(
        lambda p, batch, stats, n: loss_grads(lambda q: ppo_loss(cfg, dims, q, batch, stats, n),
                                              p), mesh, "sum")
    per_pass = []
    for idx, stats, n in zip(passes, advstats, counts):
        idx = idx.to(params.device)
        grads, metrics = grads_fn(params, tuple(x[idx] for x in dataset), stats, n)
        grads = round_grad_blocks(dims, grads, DENSE_CAST_BLOCKS)  # the whole sum's
        params, opt_state = optimizer_step(cfg, params, grads, opt_state)
        per_pass.append(metrics)
    return (params, opt_state), per_pass


def reset_envs(env: Warehouse, seed: int, n_envs: int, mesh=None) -> WarehouseState:
    """A fresh batch of ``n_envs`` env states from ``seed``; with a mesh
    (:class:`~rware_tpu_torch.parallel.sharding.Mesh`) only this rank's rows
    of it, keyed by their global indices."""
    from rware_tpu_torch.distributed import global_env_batch
    from rware_tpu_torch.parallel import batched_reset

    return global_env_batch(lambda start, count: batched_reset(env, seed, count, start)[0],
                            n_envs, mesh)


def init_runner(env: Warehouse, cfg: IPPOConfig, seed: int,
                hidden: Tuple[int, int] = (128, 128), mesh=None
                ) -> Tuple[RunnerState, BlockDims]:
    """Parameters (flax's default init, from ``seed``; a message head where
    the config has message bits), optimizer and a fresh batch of
    ``cfg.n_envs`` env states on ``env.device`` (with a mesh this rank's
    rows of it, :func:`reset_envs`)."""
    model = init_actor_critic(env.config.policy_obs_length, env.n_actions, hidden, seed,
                              env.config.msg_bits)
    params = pack_arrays(params_to_arrays(model)).detach().to(env.device)
    env_states = reset_envs(env, seed, cfg.n_envs, mesh)
    obs = policy_obs_fn(env)(env_states)
    runner = RunnerState(
        params=params, opt_state=optimizer_init(params), env_states=env_states, obs=obs,
        generator=torch.Generator().manual_seed(seed), update_idx=0, seed=seed,
    )
    return runner, BlockDims.of(model)


def policy_of(dims: BlockDims, params: torch.Tensor, model=None):
    """The :class:`ActorCritic` holding ``params`` (copied into ``model``
    when given) — what the collectors run."""
    return arrays_to_params(dims.split(params.detach()), model, dims.msg_bits)


def last_values(dims: BlockDims, params: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """(B, N) values of the observations after the rollout, by the JAX
    package's ``model.apply`` recipe (:func:`apply_forward`)."""
    with torch.no_grad():
        return apply_forward(dims.split(params), obs, dims.msg_bits)[1]


def reward_sums(traj: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reward sum, episodes) of ``traj`` on this rank."""
    return traj["reward"].sum(), traj["done"].sum()


def update_metrics(cfg: IPPOConfig, traj: Dict[str, torch.Tensor], ppo_metrics,
                   mesh=None, sums=None) -> dict:
    """The train step's metrics, as ``rware_tpu`` names them (device
    scalars).  With a mesh the reward and episode sums are the whole
    batch's, one packed all-reduce (JAX's two ``psum``), and ``cfg.n_envs``
    is the global batch; ``sums`` gives them already summed (the
    ``whole_batch_stats`` of ``parallel.sharding``)."""
    from rware_tpu_torch.parallel.sharding import psum

    reward_sum, episodes = sums if sums is not None else psum(reward_sums(traj), mesh)
    return {
        "reward_per_env": reward_sum / cfg.n_envs,
        "episodes_done": episodes,
        **ppo_metrics,
    }


class PlainTrainStep:
    """``train_step(runner, draws=None) -> (runner, metrics)``; see
    :func:`build_train_step`.  The phases are methods so that callers can
    time them: :meth:`rollout`, :meth:`advantages`, :meth:`update`."""

    def __init__(self, env: Warehouse, dims: BlockDims, cfg: IPPOConfig, mesh=None):
        from rware_tpu_torch.ops.fused_rollout import build_fused_collect

        self.env_offset = 0 if mesh is None else mesh.env_offset(cfg.n_envs)
        self.env, self.dims, self.cfg, self.mesh = env, dims, cfg, mesh
        self.collect = build_fused_collect(env.config, cfg.rollout_len, (dims.h1, dims.h2))
        self.model = policy_of(dims, torch.zeros(dims.n_params))
        self.obs_fn = policy_obs_fn(env)

    def rollout(self, runner: RunnerState):
        """(env_states, traj) of the collector's plain version with this
        update's key, on this rank's envs at their global indices."""
        policy = policy_of(self.dims, runner.params, self.model.to(runner.params.device))
        seed = collect_seed(runner.seed, runner.update_idx)
        return self.collect.plain(runner.env_states, policy, seed, self.env_offset)

    def advantages(self, runner: RunnerState, env_states, traj):
        """(obs after the rollout, advantages, targets)."""
        obs = self.obs_fn(env_states)
        adv, targets = compute_gae(self.cfg, traj["reward"], traj["value"], traj["done"],
                                   last_values(self.dims, runner.params, obs))
        return obs, adv, targets

    def update(self, runner: RunnerState, traj, adv, targets, draws=None):
        """((params, opt_state), metrics, (reward sum, episodes)) of the E x
        M passes over the flattened (T * B, N, ...) dataset: the whole
        batch's minibatches (:func:`minibatch_rows`, ``draws`` as there),
        this rank's rows of each, their statistics and the reward sums in
        one float64 all-reduce, then :func:`ppo_update_epochs`."""
        from rware_tpu_torch.parallel.sharding import rank_rows, row_moments, whole_batch_stats

        cfg, mesh = self.cfg, self.mesh

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        dataset = tuple(flat(x) for x in (traj["obs"].float(), traj["action"], traj["logp"],
                                          traj["value"], adv, targets)
                        + ((traj["bits"],) if self.dims.msg_bits else ()))
        passes = [rank_rows(idx, cfg.n_envs, mesh) for idx in
                  minibatch_rows(cfg, cfg.rollout_len * cfg.n_envs, runner.generator, draws)]
        advstats, counts, sums = whole_batch_stats(row_moments(dataset[4]), passes,
                                                   reward_sums(traj), mesh)
        (params, opt_state), per_pass = ppo_update_epochs(
            cfg, self.dims, runner.params, runner.opt_state, dataset, passes, advstats, counts,
            mesh)
        return (params, opt_state), mean_metrics(per_pass), sums

    def __call__(self, runner: RunnerState, draws=None) -> Tuple[RunnerState, dict]:
        env_states, traj = self.rollout(runner)
        obs, adv, targets = self.advantages(runner, env_states, traj)
        (params, opt_state), ppo, sums = self.update(runner, traj, adv, targets, draws)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(self.cfg, traj, ppo, sums=sums)


def build_train_step(env: Warehouse, dims: BlockDims, cfg: IPPOConfig, mesh=None
                     ) -> PlainTrainStep:
    """The plain learner: ``train_step(runner, draws=None) -> (runner,
    metrics)``.

    Collects with the plain engine and policy (the plain version of the
    fused collector, Philox draws keyed by :func:`collect_seed`), then GAE
    and E x M minibatched PPO on the flattened (T*B, N, ...) dataset, each
    minibatch's advantages normalised over it, the loss in flax's rounding
    as JAX's (:func:`ppo_loss`).  ``draws`` of a call gives
    the update's E permutations or offsets (:func:`minibatch_rows`).
    ``mesh`` (a :class:`~rware_tpu_torch.parallel.sharding.Mesh`) makes it
    data parallel with the whole batch's statistics, as JAX's step placed on
    a device mesh (``train.py:291-303``): the runner holds this rank's envs,
    ``cfg.n_envs`` is the global batch, and every pass's gradient is the
    one-rank gradient of the whole minibatch."""
    return PlainTrainStep(env, dims, cfg, mesh)
