"""The warehouse dynamics on batched tensors (the counterpart of
``rware_tpu/core/engine.py``).

One call advances every env of the batch by one transition: action decode,
collision resolution, movement, load toggles, deliveries, request-queue
resampling, rewards and termination.  Semantics follow the JAX engine rule
for rule (each rule cites the reference there):

  * target cells are edge-clamped, so walking into a wall is a committed
    no-move;
  * the loaded-agent pre-cancel downgrades the action to NOOP before
    resolution;
  * deliveries are processed goal by goal in goal order, each delivery
    immediately resampling its queue slot;
  * with nobody on the goal cell the LAST agent is credited (the
    reference's ``rewards[-1]`` wraparound).

Randomness is explicit.  The queue resample takes one raw uint32 draw per
goal (``queue_bits``): the replacement is the k-th non-queued shelf with
``k = (bits & 0x7FFFFFFF) % count`` — the JAX engine's
``_masked_uniform_pick`` law, and the fused kernels' formula.  All-zero
draws give the lowest-index non-queued shelf, the TPU kernels' scripted
rule; ``reset`` maps all-zero draws to their scripted respawn likewise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.observations import build_flattened_obs_fn
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.ops.philox import draw_distinct, rand_mod
from rware_tpu_torch.ops.resolver import resolve_moves
from rware_tpu_torch.types import Action, ObservationType, RewardType

# Rotation tables in Direction-enum coding (UP=0, DOWN=1, LEFT=2, RIGHT=3).
# Physical rotation order is UP -> RIGHT -> DOWN -> LEFT (rware/warehouse.py:118-125).
ROT_RIGHT = np.array([3, 2, 0, 1], dtype=np.int32)  # d -> clockwise(d)
ROT_LEFT = np.array([2, 3, 1, 0], dtype=np.int32)  # d -> counterclockwise(d)

# Forward displacement per Direction (dx, dy).
DIR_DX = np.array([0, 0, -1, 1], dtype=np.int32)
DIR_DY = np.array([-1, 1, 0, 0], dtype=np.int32)


class StepResult(NamedTuple):
    state: WarehouseState
    obs: Any
    rewards: torch.Tensor  # (B, N) float32
    done: torch.Tensor  # (B,) bool
    truncated: torch.Tensor  # (B,) bool — always False (rware/warehouse.py:942)
    info: Dict[str, torch.Tensor]


def build_obs_fn(config: WarehouseConfig) -> Callable[[WarehouseState], Any]:
    """Observation function for the configured observation family.

    DICT shares the FLATTENED function, as in the JAX package.  The image
    families are not ported yet.
    """
    if config.observation_type in (ObservationType.FLATTENED, ObservationType.DICT):
        return build_flattened_obs_fn(config)
    raise NotImplementedError(
        f"observation type {config.observation_type!r} is not ported yet"
    )


def n_reset_draws(config: WarehouseConfig) -> int:
    """Raw draws one reset takes: N spawn cells, N directions, R queue."""
    return 2 * config.n_agents + config.request_queue_size


def build_reset_fn(config: WarehouseConfig) -> Callable[[torch.Tensor], WarehouseState]:
    """Returns ``reset(bits) -> state`` for ``bits`` (B, 2N+R) uint32 draws.

    Mirrors rware/warehouse.py:757-800: shelves spawn at their row-major rack
    slots; agents spawn uniformly over ALL cells without replacement with
    uniform directions; the request queue is a uniform sample of shelves
    without replacement.  The draws are mapped as in the fused kernels'
    autoreset (``_draw_distinct`` / ``_rand_mod``).
    """
    layout = config.compile_layout()
    height, width = layout.grid_size
    n, s, r = config.n_agents, layout.n_shelves, config.request_queue_size
    slots = layout.shelf_slots

    def reset(bits: torch.Tensor) -> WarehouseState:
        b, dev = bits.shape[0], bits.device
        cells = draw_distinct(bits[:, :n], height * width).to(torch.int32)
        dirs = rand_mod(bits[:, n : 2 * n], 4).to(torch.int32)
        queue = draw_distinct(bits[:, 2 * n : 2 * n + r], s).to(torch.int32)

        def home(col):
            return torch.as_tensor(slots[:, col], device=dev).expand(b, s).clone()

        zeros = torch.zeros(b, dtype=torch.int32, device=dev)
        return WarehouseState(
            agent_x=cells % width,
            agent_y=cells // width,
            agent_dir=dirs,
            agent_carrying=torch.full((b, n), -1, dtype=torch.int32, device=dev),
            agent_has_delivered=torch.zeros((b, n), dtype=torch.bool, device=dev),
            agent_message=torch.zeros(
                (b, n, config.msg_bits), dtype=torch.float32, device=dev
            ),
            shelf_x=home(0),
            shelf_y=home(1),
            request_queue=queue,
            cur_steps=zeros,
            cur_inactive_steps=zeros.clone(),
        )

    return reset


def masked_uniform_pick(bits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per env, the k-th True index of ``mask`` (B, S) with
    ``k = (bits & 0x7FFFFFFF) % max(count, 1)`` (assumes >= 1 True)."""
    m = mask.to(torch.int32)
    count = m.sum(dim=1).clamp(min=1)
    k = rand_mod(bits, count)
    return (torch.cumsum(m, dim=1) > k[:, None]).to(torch.int32).argmax(dim=1)


def _first_index(mask: torch.Tensor, default) -> torch.Tensor:
    """Per env, the lowest True index of ``mask`` (B, K), else ``default``."""
    return torch.where(
        mask.any(dim=1), mask.to(torch.int32).argmax(dim=1), default
    ).to(torch.int32)


def build_transition_fn(
    config: WarehouseConfig,
) -> Callable[..., Tuple[WarehouseState, torch.Tensor, torch.Tensor, Dict]]:
    """Returns ``transition(state, actions, queue_bits=None) -> (state,
    rewards, done, info)``: the dynamics of one step without observations.

    ``actions`` is (B, N) int; ``queue_bits`` (B, G) uint32 draws, one per
    goal, or None for all-zero draws (lowest-index replacement).
    """
    if config.msg_bits:
        raise NotImplementedError("message bits are not ported yet")
    layout = config.compile_layout()
    height, width = layout.grid_size
    n = config.n_agents
    n_shelves = layout.n_shelves
    goals = [(int(x), int(y)) for x, y in layout.goals]
    highways_np = layout.highways.astype(bool)
    reward_type = config.reward_type
    max_steps = config.max_steps
    max_inactive = config.max_inactivity_steps

    def transition(state: WarehouseState, actions: torch.Tensor,
                   queue_bits: Optional[torch.Tensor] = None):
        dev = state.device
        b = state.batch_size
        highways = torch.as_tensor(highways_np, device=dev)
        rot_left = torch.as_tensor(ROT_LEFT, device=dev)
        rot_right = torch.as_tensor(ROT_RIGHT, device=dev)
        dir_dx = torch.as_tensor(DIR_DX, device=dev)
        dir_dy = torch.as_tensor(DIR_DY, device=dev)
        acts = actions.to(torch.int32).reshape(b, n)
        ax, ay, adir = state.agent_x, state.agent_y, state.agent_dir
        adir_i = adir.to(torch.int64)
        carrying = state.agent_carrying

        # Requested target cells, edge-clamped.
        is_forward = acts == Action.FORWARD
        tx = torch.clamp(ax + torch.where(is_forward, dir_dx[adir_i], 0), 0, width - 1)
        ty = torch.clamp(ay + torch.where(is_forward, dir_dy[adir_i], 0), 0, height - 1)

        # Pre-cancel: a loaded agent moving onto a standing shelf, unless
        # that shelf is held by a loaded agent at the target.
        shelf_at_target = (
            (tx[:, :, None] == state.shelf_x[:, None, :])
            & (ty[:, :, None] == state.shelf_y[:, None, :])
        ).any(dim=2)
        agent_at_target = (tx[:, :, None] == ax[:, None, :]) & (
            ty[:, :, None] == ay[:, None, :]
        )
        target_agent_loaded = (agent_at_target & (carrying[:, None, :] >= 0)).any(dim=2)
        moving = (tx != ax) | (ty != ay)
        cancelled = (carrying >= 0) & moving & shelf_at_target & ~target_agent_loaded
        acts = torch.where(cancelled, int(Action.NOOP), acts)
        tx = torch.where(cancelled, ax, tx)
        ty = torch.where(cancelled, ay, ty)

        # Collision resolution; failed agents are downgraded to NOOP.
        committed = resolve_moves(ax, ay, tx, ty)
        acts = torch.where(committed, acts, int(Action.NOOP))

        # Movement and rotation.
        moved = committed & (acts == Action.FORWARD)
        new_ax = torch.where(moved, tx, ax)
        new_ay = torch.where(moved, ty, ay)
        new_dir = torch.where(
            acts == Action.LEFT,
            rot_left[adir_i],
            torch.where(acts == Action.RIGHT, rot_right[adir_i], adir),
        )

        # Carried shelves ride along (index S drops the write).
        carry_idx = torch.where(moved & (carrying >= 0), carrying, n_shelves)
        carry_idx = carry_idx.to(torch.int64)
        pad = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        new_sx = torch.cat([state.shelf_x, pad], 1).scatter(1, carry_idx, new_ax)[:, :n_shelves]
        new_sy = torch.cat([state.shelf_y, pad], 1).scatter(1, carry_idx, new_ay)[:, :n_shelves]

        # Toggle load: pickup of a standing shelf under the agent (pre-step
        # shelf positions); drops only off-highway.
        toggling = acts == Action.TOGGLE_LOAD
        under = (new_ax[:, :, None] == state.shelf_x[:, None, :]) & (
            new_ay[:, :, None] == state.shelf_y[:, None, :]
        )
        shelf_under = torch.where(
            under.any(dim=2), under.to(torch.int32).argmax(dim=2), -1
        ).to(torch.int32)
        pickup = toggling & (carrying < 0) & (shelf_under >= 0)
        on_highway = highways[new_ay.to(torch.int64), new_ax.to(torch.int64)]
        drop = toggling & (carrying >= 0) & ~on_highway
        rewards = torch.zeros((b, n), dtype=torch.float32, device=dev)
        if reward_type == RewardType.TWO_STAGE:
            rewards = rewards + torch.where(drop & state.agent_has_delivered, 0.5, 0.0)
        new_carrying = torch.where(pickup, shelf_under, torch.where(drop, -1, carrying))
        has_delivered = torch.where(drop, False, state.agent_has_delivered)

        # Deliveries, queue resampling and rewards, goal by goal.
        queue = state.request_queue
        n_delivered = torch.zeros(b, dtype=torch.int32, device=dev)
        if config.request_queue_size > 0:
            shelf_ids = torch.arange(n_shelves, dtype=torch.int32, device=dev)
            rows = torch.arange(b, device=dev)
            if queue_bits is None:
                queue_bits = torch.zeros((b, len(goals)), dtype=torch.int64, device=dev)
            for g, (gx, gy) in enumerate(goals):
                sid = _first_index((new_sx == gx) & (new_sy == gy), -1)
                slot_match = queue == sid[:, None]
                delivered = (sid >= 0) & slot_match.any(dim=1)
                slot = slot_match.to(torch.int32).argmax(dim=1)

                # The delivered shelf is still queued at sampling time and so
                # excluded; with every shelf queued (R == S) it stays requested.
                free = ~(queue[:, :, None] == shelf_ids).any(dim=1)
                new_req = torch.where(
                    free.any(dim=1), masked_uniform_pick(queue_bits[:, g], free), sid
                ).to(torch.int32)
                queue = queue.clone()
                queue[rows, slot] = torch.where(delivered, new_req, queue[rows, slot])

                aid = _first_index((new_ax == gx) & (new_ay == gy), n - 1).to(torch.int64)
                credit = torch.zeros((b, n), dtype=torch.bool, device=dev)
                credit[rows, aid] = delivered
                if reward_type == RewardType.GLOBAL:
                    rewards = rewards + delivered.to(torch.float32)[:, None]
                elif reward_type == RewardType.INDIVIDUAL:
                    rewards = rewards + credit.to(torch.float32)
                else:  # TWO_STAGE
                    rewards = rewards + 0.5 * credit.to(torch.float32)
                    has_delivered = has_delivered | credit
                n_delivered = n_delivered + delivered.to(torch.int32)

        # Termination (rware/warehouse.py:929-942).
        inactive = torch.where(n_delivered > 0, 0, state.cur_inactive_steps + 1)
        steps = state.cur_steps + 1
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        if max_inactive:
            done = done | (inactive >= max_inactive)
        if max_steps:
            done = done | (steps >= max_steps)

        new_state = state.replace(
            agent_x=new_ax,
            agent_y=new_ay,
            agent_dir=new_dir,
            agent_carrying=new_carrying,
            agent_has_delivered=has_delivered,
            shelf_x=new_sx,
            shelf_y=new_sy,
            request_queue=queue,
            cur_steps=steps,
            cur_inactive_steps=inactive,
        )
        info = {
            "deliveries": n_delivered,
            "failed_moves": (~committed).to(torch.int32).sum(dim=1),
        }
        return new_state, rewards, done, info

    return transition


def build_step_fn(
    config: WarehouseConfig,
    obs_fn: Optional[Callable[[WarehouseState], Any]] = None,
) -> Callable[..., StepResult]:
    """Returns ``step(state, actions, queue_bits=None) -> StepResult``: the
    transition plus the observation of the new state."""
    transition = build_transition_fn(config)
    if obs_fn is None:
        obs_fn = build_obs_fn(config)

    def step(state: WarehouseState, actions: torch.Tensor,
             queue_bits: Optional[torch.Tensor] = None) -> StepResult:
        new_state, rewards, done, info = transition(state, actions, queue_bits)
        return StepResult(
            state=new_state,
            obs=obs_fn(new_state),
            rewards=rewards,
            done=done,
            truncated=torch.zeros_like(done),
            info=info,
        )

    return step
