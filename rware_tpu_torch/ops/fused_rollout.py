"""The fused rollout kernel (K1) and the fused MLP collector kernel (K2a).

* :func:`build_fused_rollout` replaces
  ``rware_tpu/ops/pallas_rollout.py::build_pallas_rollout``: T env steps per
  launch with random or scripted actions and autoreset, returning the final
  state, per-agent reward sums and episode counts.
* :func:`build_fused_collect` replaces ``build_pallas_collect`` in mode
  ``policy="mlp"``, FLATTENED observations, ``msg_bits=0``: per step the
  observation, the shared :class:`ActorCritic` forward, a Gumbel-argmax
  sample and the env step, with the trajectory streamed out in the
  ``(T, B, N, ...)`` layout.

Each wrapper launches its CUDA kernel (``csrc/fused_rollout.cu``,
``csrc/fused_collect.cu``) for tensors on a CUDA device, and runs its plain
PyTorch version (``.plain``) only for tensors on the CPU; it counts its
kernel launches in ``.launches``.  Both draw from the same Philox stream
(:mod:`rware_tpu_torch.ops.philox`), so kernel and plain version agree bit
for bit in every mode.  Scripted (K1) and deterministic (K2a) modes draw
zeros: lowest-index queue replacement, agent i respawning at cell i facing
UP, the queue restarting as 0..R-1 — the TPU kernels' scripted rules.

The kernels take the state packed as one (ROWS, B) int32 tensor with the
env index minor (rows: agent x, y, dir, carrying, has_delivered; shelf x, y;
queue; inactive and step counters), so their loads are coalesced; the
transposes from and to the public (B, ...) layout live here.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.engine import (
    build_obs_fn,
    build_reset_fn,
    build_transition_fn,
    n_reset_draws,
)
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.models.networks import ActorCritic, sample_action
from rware_tpu_torch.ops import philox
from rware_tpu_torch.types import ObservationType

# Limits of the kernels' per-thread state arrays (csrc/env_core.cuh).
MAX_AGENTS, MAX_SHELVES, MAX_QUEUE = 32, 512, 64
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def _check_config(config: WarehouseConfig) -> None:
    if config.msg_bits:
        raise NotImplementedError("message bits are not ported yet")
    layout = config.compile_layout()
    if (config.n_agents > MAX_AGENTS or layout.n_shelves > MAX_SHELVES
            or config.request_queue_size > MAX_QUEUE):
        raise ValueError(
            f"the fused kernels take at most {MAX_AGENTS} agents, {MAX_SHELVES} "
            f"shelves and a queue of {MAX_QUEUE}"
        )


def _check_state(config: WarehouseConfig, state: WarehouseState) -> None:
    """The kernels index the packed state by the config's sizes."""
    want = (config.n_agents, config.compile_layout().n_shelves, config.request_queue_size)
    got = (state.n_agents, state.n_shelves, state.request_queue.shape[1])
    if got != want or state.batch_size < 1:
        raise ValueError(
            f"state of {state.batch_size} envs with (agents, shelves, queue) {got}; "
            f"the config needs at least 1 env and {want}"
        )


def _check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return seed


def pack_state(state: WarehouseState) -> torch.Tensor:
    """(ROWS, B) int32, env index minor."""
    rows = [
        state.agent_x, state.agent_y, state.agent_dir, state.agent_carrying,
        state.agent_has_delivered, state.shelf_x, state.shelf_y,
        state.request_queue, state.cur_inactive_steps[:, None],
        state.cur_steps[:, None],
    ]
    return torch.cat([r.to(torch.int32) for r in rows], dim=1).t().contiguous()


def unpack_state(packed: torch.Tensor, like: WarehouseState) -> WarehouseState:
    """Inverse of :func:`pack_state`; ``like`` gives the field shapes."""
    n, s, r = like.n_agents, like.n_shelves, like.request_queue.shape[1]
    cols = packed.t()
    sizes = [n, n, n, n, n, s, s, r, 1, 1]
    ax, ay, ad, carry, hd, sx, sy, q, inact, steps = torch.split(cols, sizes, dim=1)
    return WarehouseState(
        agent_x=ax.contiguous(),
        agent_y=ay.contiguous(),
        agent_dir=ad.contiguous(),
        agent_carrying=carry.contiguous(),
        agent_has_delivered=hd != 0,
        agent_message=like.agent_message,
        shelf_x=sx.contiguous(),
        shelf_y=sy.contiguous(),
        request_queue=q.contiguous(),
        cur_steps=steps[:, 0].contiguous(),
        cur_inactive_steps=inact[:, 0].contiguous(),
    )


def layout_buffer(config: WarehouseConfig, device) -> torch.Tensor:
    """[slot_x (S) | slot_y (S) | goal_x (G) | goal_y (G) | highway (H*W)]."""
    layout = config.compile_layout()
    parts = [
        layout.shelf_slots[:, 0], layout.shelf_slots[:, 1],
        layout.goals[:, 0], layout.goals[:, 1], layout.highways.reshape(-1),
    ]
    buf = np.concatenate([np.asarray(p, dtype=np.int32) for p in parts])
    return torch.from_numpy(buf).to(device)


def _dims(config: WarehouseConfig) -> list:
    layout = config.compile_layout()
    h, w = layout.grid_size
    return [
        config.n_agents, layout.n_shelves, config.request_queue_size,
        layout.n_goals, h, w, int(config.reward_type),
        config.max_steps or 0, config.max_inactivity_steps or 0,
    ]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class _Draws:
    """Per-step draws of the plain versions: Philox, or zeros when the mode
    is scripted / deterministic."""

    def __init__(self, config: WarehouseConfig, seed: int, zero: bool, b: int, device):
        self.seed, self.zero, self.b = seed, zero, b
        self.envs = torch.arange(b, device=device)
        self.n_goals = config.compile_layout().n_goals
        self.n_reset = n_reset_draws(config)

    def __call__(self, step: int, purpose: int, n: int) -> torch.Tensor:
        if self.zero:
            return torch.zeros((self.b, n), dtype=torch.int64, device=self.envs.device)
        return philox.uniform_bits(self.seed, self.envs, step, purpose, n)

    def queue(self, step):
        return self(step, philox.QUEUE, self.n_goals)

    def respawn(self, step):
        return self(step, philox.RESPAWN, self.n_reset)


class FusedRollout:
    """``rollout(state, seed, actions=None) -> (state, rewards_sum (B, N)
    f32, episodes (B,) int32)``; see :func:`build_fused_rollout`."""

    def __init__(self, config: WarehouseConfig, n_steps: int, scripted: bool = False):
        _check_config(config)
        self.config = config
        self.n_steps = n_steps
        self.scripted = scripted
        self.launches = 0
        self._transition = build_transition_fn(config)
        self._reset = build_reset_fn(config)
        self._layouts: Dict[torch.device, torch.Tensor] = {}

    def _check_actions(self, state, actions):
        if self.scripted != (actions is not None):
            raise ValueError("scripted mode takes actions (T, B, N); random mode takes none")
        if actions is not None:
            want = (self.n_steps, state.batch_size, self.config.n_agents)
            if tuple(actions.shape) != want or actions.device != state.device:
                raise ValueError(f"actions must be {want} on {state.device}")

    def __call__(self, state: WarehouseState, seed, actions: Optional[torch.Tensor] = None):
        _check_state(self.config, state)
        self._check_actions(state, actions)
        seed = _check_seed(seed)
        if state.device.type == "cuda":
            return self._launch(state, seed, actions)
        if state.device.type == "cpu":
            return self.plain(state, seed, actions)
        raise ValueError(f"no fused rollout for device {state.device}")

    def plain(self, state: WarehouseState, seed, actions: Optional[torch.Tensor] = None):
        """The plain PyTorch version: T steps of the batched engine with the
        kernel's draws."""
        self._check_actions(state, actions)
        seed = _check_seed(seed)
        b, n = state.batch_size, self.config.n_agents
        draws = _Draws(self.config, seed, self.scripted, b, state.device)
        rew = torch.zeros((b, n), dtype=torch.float32, device=state.device)
        epis = torch.zeros(b, dtype=torch.int32, device=state.device)
        for t in range(self.n_steps):
            if self.scripted:
                acts = actions[t]
            else:
                acts = philox.rand_mod(draws(t, philox.ACTION, n), 5)
            state, rewards, done, _ = self._transition(state, acts, draws.queue(t))
            state = self._reset(draws.respawn(t)).where(done, state)
            rew = rew + rewards
            epis = epis + done.to(torch.int32)
        return state, rew, epis

    def _launch(self, state, seed, actions):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = state.device
        b, n = state.batch_size, self.config.n_agents
        if dev not in self._layouts:
            self._layouts[dev] = layout_buffer(self.config, dev)
        with torch.cuda.device(dev):
            packed = pack_state(state)
            out = torch.empty_like(packed)
            acts = None
            if actions is not None:
                acts = actions.to(torch.int32).permute(0, 2, 1).contiguous()  # (T, N, B)
            rewards = torch.empty((n, b), dtype=torch.float32, device=dev)
            episodes = torch.empty(b, dtype=torch.int32, device=dev)
            code = lib.rw_fused_rollout(
                *_dims(self.config), seed, int(self.scripted), self.n_steps, b,
                _ptr(self._layouts[dev]), _ptr(packed), _ptr(out), _ptr(acts),
                _ptr(rewards), _ptr(episodes), torch.cuda.current_stream(dev).cuda_stream,
            )
            check(lib, code, "fused_rollout")
            self.launches += 1
        return unpack_state(out, state), rewards.t().contiguous(), episodes


def build_fused_rollout(config: WarehouseConfig, n_steps: int, scripted: bool = False) -> FusedRollout:
    """Returns ``rollout(state, seed, actions=None) -> (state, rewards_sum
    (B, N) f32, episodes (B,) int32)`` (the contract of
    ``pallas_rollout.py:666-677``).  Random mode takes no actions; scripted
    mode takes (T, B, N) int actions.  ``seed`` keys the Philox stream."""
    return FusedRollout(config, n_steps, scripted)


def collect_smem_bytes(obs_len: int, hidden: Sequence[int], n_actions: int, threads: int) -> int:
    """Dynamic shared memory of one collector block (csrc/fused_collect.cu)."""
    h1, h2 = hidden
    f32 = h1 + h2 + n_actions * h2 + n_actions + h2 + 1
    bf16 = h1 * obs_len + h2 * h1 + (obs_len + h1) * threads
    return ((4 * f32 + 15) // 16) * 16 + 2 * bf16


class FusedCollect:
    """``collect(state, policy, seed) -> (state, traj)``; see
    :func:`build_fused_collect`."""

    def __init__(self, config: WarehouseConfig, n_steps: int,
                 hidden: Tuple[int, int] = (128, 128), deterministic: bool = False):
        _check_config(config)
        if config.observation_type not in (ObservationType.FLATTENED, ObservationType.DICT):
            raise NotImplementedError("the fused collector takes FLATTENED observations")
        if len(hidden) != 2 or any(h % 8 for h in hidden):
            raise ValueError("the fused collector takes two hidden layers, multiples of 8")
        self.config = config
        self.n_steps = n_steps
        self.hidden = tuple(hidden)
        self.deterministic = deterministic
        self.obs_len = config.flattened_obs_length
        self.launches = 0
        self.threads = next(
            (t for t in (128, 64, 32)
             if collect_smem_bytes(self.obs_len, self.hidden, 5, t) <= SMEM_LIMIT),
            None,
        )
        if self.threads is None:
            raise ValueError("observation too long for the collector's shared memory")
        self._obs = build_obs_fn(config)
        self._transition = build_transition_fn(config)
        self._reset = build_reset_fn(config)
        self._layouts: Dict[torch.device, torch.Tensor] = {}

    def _check_policy(self, policy: ActorCritic):
        if policy.hidden != self.hidden or policy.obs_dim != self.obs_len or policy.n_actions != 5:
            raise ValueError(
                f"policy must be ActorCritic(obs_dim={self.obs_len}, n_actions=5, "
                f"hidden={self.hidden})"
            )

    def __call__(self, state: WarehouseState, policy: ActorCritic, seed):
        _check_state(self.config, state)
        self._check_policy(policy)
        seed = _check_seed(seed)
        if state.device.type == "cuda":
            return self._launch(state, policy, seed)
        if state.device.type == "cpu":
            return self.plain(state, policy, seed)
        raise ValueError(f"no fused collector for device {state.device}")

    @torch.no_grad()
    def plain(self, state: WarehouseState, policy: ActorCritic, seed):
        """The plain PyTorch version: observe -> ActorCritic -> sample ->
        step, with the kernel's draws."""
        self._check_policy(policy)
        seed = _check_seed(seed)
        b, n = state.batch_size, self.config.n_agents
        draws = _Draws(self.config, seed, self.deterministic, b, state.device)
        out = {k: [] for k in ("obs", "action", "logp", "value", "reward", "done")}
        for t in range(self.n_steps):
            obs = self._obs(state).to(torch.bfloat16)
            logits, value = policy(obs)
            u = None
            if not self.deterministic:
                u = philox.gumbel_uniform(draws(t, philox.ACTION, n * 5).reshape(b, n, 5))
            action, logp = sample_action(logits, u)
            state, rewards, done, _ = self._transition(state, action, draws.queue(t))
            state = self._reset(draws.respawn(t)).where(done, state)
            for k, v in zip(out, (obs, action, logp, value, rewards, done)):
                out[k].append(v)
        return state, {k: torch.stack(v) for k, v in out.items()}

    @torch.no_grad()
    def _launch(self, state, policy, seed):
        from rware_tpu_torch.ops._build import check, load_library

        lib = load_library()
        dev = state.device
        b, n, t_len, l_obs = state.batch_size, self.config.n_agents, self.n_steps, self.obs_len
        h1, h2 = self.hidden
        if dev not in self._layouts:
            self._layouts[dev] = layout_buffer(self.config, dev)
        with torch.cuda.device(dev):
            packed = pack_state(state)
            out = torch.empty_like(packed)
            d0, d1 = policy.dense
            weights = [
                d0.weight.to(device=dev, dtype=torch.bfloat16).contiguous(),
                d0.bias.to(device=dev, dtype=torch.float32).contiguous(),
                d1.weight.to(device=dev, dtype=torch.bfloat16).contiguous(),
                d1.bias.to(device=dev, dtype=torch.float32).contiguous(),
                policy.policy.weight.to(device=dev, dtype=torch.float32).contiguous(),
                policy.policy.bias.to(device=dev, dtype=torch.float32).contiguous(),
                policy.value.weight.to(device=dev, dtype=torch.float32).contiguous(),
                policy.value.bias.to(device=dev, dtype=torch.float32).contiguous(),
            ]
            traj = {
                "obs": torch.empty((t_len, b, n, l_obs), dtype=torch.bfloat16, device=dev),
                "action": torch.empty((t_len, b, n), dtype=torch.int32, device=dev),
                "logp": torch.empty((t_len, b, n), dtype=torch.float32, device=dev),
                "value": torch.empty((t_len, b, n), dtype=torch.float32, device=dev),
                "reward": torch.empty((t_len, b, n), dtype=torch.float32, device=dev),
                "done": torch.empty((t_len, b), dtype=torch.bool, device=dev),
            }
            smem = collect_smem_bytes(l_obs, self.hidden, 5, self.threads)
            code = lib.rw_fused_collect(
                *_dims(self.config), seed, int(self.deterministic), t_len, b,
                self.config.sensor_range, int(self.config.normalised_coordinates),
                l_obs, h1, h2, 5, self.threads, smem,
                _ptr(self._layouts[dev]), _ptr(packed), _ptr(out),
                *[_ptr(w) for w in weights],
                *[_ptr(traj[k]) for k in ("obs", "action", "logp", "value", "reward", "done")],
                torch.cuda.current_stream(dev).cuda_stream,
            )
            check(lib, code, "fused_collect")
            self.launches += 1
        return unpack_state(out, state), traj


def build_fused_collect(config: WarehouseConfig, n_steps: int,
                        hidden: Tuple[int, int] = (128, 128),
                        deterministic: bool = False) -> FusedCollect:
    """Returns ``collect(state, policy, seed) -> (state, traj)`` with ``traj``
    = obs (T, B, N, L) bf16; action (T, B, N) int32; logp, value, reward
    (T, B, N) f32; done (T, B) bool — the ``native_traj=False`` layout of
    ``pallas_rollout.py:1812-1815``.  ``policy`` is an
    :class:`ActorCritic` with ``hidden``; ``deterministic`` takes the argmax
    action and the scripted draws."""
    return FusedCollect(config, n_steps, hidden, deterministic)
