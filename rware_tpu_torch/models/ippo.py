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
random stream is keyed by :func:`collect_seed`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from rware_tpu_torch.core.engine import build_policy_obs_fn
from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.models.networks import (
    BlockDims,
    apply_forward,
    arrays_to_params,
    init_actor_critic,
    pack_arrays,
    params_to_arrays,
    train_forward,
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


def ppo_loss(cfg: IPPOConfig, dims: BlockDims, params: torch.Tensor, batch):
    """Clipped-PPO loss on a flat (M, N, ...) minibatch
    ``(obs, action, old_logp, old_value, adv, target)``, and the bits (M, N,
    M_bits) as a 7th entry where ``dims`` has message bits."""
    obs, action, old_logp, old_value, adv, target = batch[:6]
    heads, value = train_forward(dims.split(params), obs, dims.msg_bits)
    return clipped_ppo_terms(cfg, heads, value, action, old_logp, old_value, adv, target,
                             bits=batch[6] if dims.msg_bits else None)


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


def ppo_update_epochs(cfg: IPPOConfig, dims: BlockDims, params, opt_state, dataset,
                      generator: torch.Generator):
    """E epochs x M minibatches of SGD over a flat dataset tuple (leading
    axis T*B); ``cfg.minibatch_mode`` picks the minibatches.  Returns
    ((params, opt_state), per-pass metric dicts)."""
    n_data = dataset[0].shape[0]
    mb = n_data // cfg.minibatches
    dev = params.device
    per_pass = []
    for _ in range(cfg.epochs):
        if cfg.minibatch_mode == "block":
            off = int(torch.randint(0, n_data, (), generator=generator))
            rolled = tuple(torch.roll(x, off, dims=0) for x in dataset)
            batches = [tuple(x[i * mb:(i + 1) * mb] for x in rolled)
                       for i in range(cfg.minibatches)]
        elif cfg.minibatch_mode == "shuffle":
            perm = torch.randperm(n_data, generator=generator)[: mb * cfg.minibatches]
            idxs = perm.reshape(cfg.minibatches, mb).to(dev)
            batches = [tuple(x[i] for x in dataset) for i in idxs]
        else:
            raise ValueError(f"unknown minibatch_mode {cfg.minibatch_mode!r}")
        for batch in batches:
            grads, metrics = loss_grads(lambda p: ppo_loss(cfg, dims, p, batch), params)
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


def update_metrics(cfg: IPPOConfig, traj: Dict[str, torch.Tensor], ppo_metrics,
                   mesh=None) -> dict:
    """The train step's metrics, as ``rware_tpu`` names them (device
    scalars).  With a mesh the reward and episode sums are the whole
    batch's, one packed all-reduce (JAX's two ``psum``), and ``cfg.n_envs``
    is the global batch."""
    from rware_tpu_torch.parallel.sharding import psum

    reward_sum, episodes = psum((traj["reward"].sum(), traj["done"].sum()), mesh)
    return {
        "reward_per_env": reward_sum / cfg.n_envs,
        "episodes_done": episodes,
        **ppo_metrics,
    }


def build_train_step(env: Warehouse, dims: BlockDims, cfg: IPPOConfig
                     ) -> Callable[[RunnerState], Tuple[RunnerState, dict]]:
    """The plain learner: ``train_step(runner) -> (runner, metrics)``.

    Collects with the plain engine and policy (the plain version of the
    fused collector, Philox draws keyed by :func:`collect_seed`), then GAE
    and E x M minibatched PPO on the flattened (T*B, N, ...) dataset."""
    from rware_tpu_torch.ops.fused_rollout import build_fused_collect

    collect = build_fused_collect(env.config, cfg.rollout_len, (dims.h1, dims.h2))
    model = policy_of(dims, torch.zeros(dims.n_params))
    obs_fn = policy_obs_fn(env)

    def train_step(runner: RunnerState):
        policy = policy_of(dims, runner.params, model.to(runner.params.device))
        seed = collect_seed(runner.seed, runner.update_idx)
        env_states, traj = collect.plain(runner.env_states, policy, seed)
        obs = obs_fn(env_states)
        adv, targets = compute_gae(cfg, traj["reward"], traj["value"], traj["done"],
                                   last_values(dims, runner.params, obs))

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        dataset = tuple(flat(x) for x in (traj["obs"].float(), traj["action"], traj["logp"],
                                          traj["value"], adv, targets)
                        + ((traj["bits"],) if dims.msg_bits else ()))
        (params, opt_state), per_pass = ppo_update_epochs(
            cfg, dims, runner.params, runner.opt_state, dataset, runner.generator)
        new = dataclasses.replace(runner, params=params, opt_state=opt_state,
                                  env_states=env_states, obs=obs,
                                  update_idx=runner.update_idx + 1)
        return new, update_metrics(cfg, traj, mean_metrics(per_pass))

    return train_step
