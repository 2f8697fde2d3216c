"""K1's launch plan and the premise of its shelf map, on the CPU.

``ops/fused_rollout.rollout_plan`` sets the fused rollout kernel's route,
tile and the regions of each env's compact state (``csrc/fused_rollout.cu``
refuses a plan whose regions do not hold what it keeps there).  The map routes
keep one shelf id a cell: they agree with the scans over the shelves' list
only while no two shelves share a cell.  These tests hold the plan to the
kernel's admission rules for every config ``chip_smoke.py`` runs K1 on and at
the kernel's limits, and hold the premise on random and scripted rollouts of
the port's plain engine and of the JAX package's XLA engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import rware_tpu
import rware_tpu_torch
from rware_tpu.core import engine as jax_engine
from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.ops.fused_rollout import (
    MAX_AGENTS,
    MAX_QUEUE,
    MAX_SHELVES,
    ROLLOUT_MAX_WAVES,
    ROLLOUT_REGIONS,
    ROLLOUT_ROUTES,
    SM_COUNT,
    SMEM_LIMIT,
    build_fused_rollout,
    rollout_plan,
)
from rware_tpu_torch.parallel import batched_reset
from rware_tpu_torch.testing import DOWN, LEFT, RIGHT, UP, make_state

torch.set_num_threads(1)

BATCHES = (65536, 16384, 1000, 33, 1)
FORWARD, TURN_LEFT, TURN_RIGHT, NOOP, TOGGLE = 1, 2, 3, 0, 4


def region_sizes(config: WarehouseConfig, map_bytes: int) -> dict:
    """What the kernel keeps in each region, in words."""
    layout = config.compile_layout()
    h, w = layout.grid_size
    n = config.n_agents
    return {"agents": 2 * n, "reward": n, "queue": config.request_queue_size, "count": 2,
            "map": -(-h * w * map_bytes // 4)}


def check_plan(plan, config: WarehouseConfig, batch: int) -> None:
    """``rollout_plan_ok`` of csrc/fused_rollout.cu, and the plan's own
    promises: the route named, the tile in range, every region in order and
    holding what the kernel keeps there, a block's shared memory within
    227 KB."""
    assert plan.route in ROLLOUT_ROUTES
    assert plan.te in (32, 64, 128)
    assert 0 <= plan.carveout <= 100
    assert plan.blocks(batch) * plan.te >= batch
    assert len(plan.args()) == 11
    if plan.route == "scan":
        assert plan.map_bytes == 0 and plan.smem == 0 and plan.scratch_words == 0
        return
    assert plan.map_bytes == (1 if config.compile_layout().n_shelves < 255 else 2)
    sizes = region_sizes(config, plan.map_bytes)
    assert plan.offsets[0] == 0
    for name in ROLLOUT_REGIONS:
        start, end = plan.region(name)
        assert end - start >= sizes[name], name  # regions in order: none overlaps another
    assert plan.stride % 32 == 0
    if plan.route == "shared":
        assert plan.stride >= plan.te and plan.smem == 4 * plan.rows * plan.stride
        assert plan.smem <= SMEM_LIMIT and plan.scratch_words == 0
        assert plan.blocks_per_sm >= 1
    else:
        assert plan.stride >= batch and plan.smem == 0
        assert plan.scratch_words == plan.rows * plan.stride


@pytest.mark.parametrize("m", [0, 2, 8])
@pytest.mark.parametrize("env_id", chip_smoke.K1_CONFIGS)
def test_rollout_plan_for_the_smoke_configs(env_id, m):
    config = rware_tpu_torch.make(env_id, device="cpu", msg_bits=m).config
    for batch in BATCHES:
        plan = rollout_plan(config, batch)
        check_plan(plan, config, batch)
        assert plan.route != "scan"  # every registered grid takes a map
        if plan.route == "shared":  # at most two waves of tiles
            assert plan.waves(batch) <= ROLLOUT_MAX_WAVES
        else:
            assert rollout_plan(config, batch, route="shared").waves(batch) > ROLLOUT_MAX_WAVES
        for route in ROLLOUT_ROUTES:  # every route takes every registered config
            check_plan(rollout_plan(config, batch, route=route), config, batch)
    # the messages take no room: the kernel writes the last step's bits at the end
    assert rollout_plan(config, 1000).rows == rollout_plan(
        rware_tpu_torch.make(env_id, device="cpu").config, 1000).rows


def test_rollout_plan_routes_at_the_main_shape():
    """tiny-2ag at bench.py's B=65,536: tiles of 128 in shared memory, four a
    SM, one wave; large-8ag (600 bytes an env) takes two waves of tiles;
    5x5-4ag (1,576 bytes) would take four, so its envs go to device memory."""
    tiny = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu").config
    plan = rollout_plan(tiny, 65536)
    assert (plan.route, plan.te, plan.rows, plan.smem) == ("shared", 128, 38, 19456)
    assert plan.blocks(65536) == 512 <= SM_COUNT * plan.blocks_per_sm
    assert rollout_plan(tiny, 1000).te == 32  # small batches spread over the SMs
    large = rware_tpu_torch.make("rware-large-8ag-v2", device="cpu").config
    assert (rollout_plan(large, 65536).route, rollout_plan(large, 65536).waves(65536)) == (
        "shared", 2)
    wide = rware_tpu_torch.make("rware-5x5-4ag-v2", device="cpu").config
    assert rollout_plan(wide, 65536).route == "global"
    assert rollout_plan(wide, 16384).route == "shared"


def layout_str(h: int, w: int, n_shelves: int) -> str:
    """An h x w layout with ``n_shelves`` rack slots spread over the rows
    below the top one, and two goals in the top row."""
    grid = [["."] * w for _ in range(h)]
    cells = np.linspace(w, h * w - 1, n_shelves).astype(int)
    for c in cells:
        grid[c // w][c % w] = "x"
    grid[0][0] = grid[0][w - 1] = "g"
    return "\n".join("".join(row) for row in grid)


@pytest.mark.parametrize("h, w, n, s, r, route", [
    (256, 256, MAX_AGENTS, MAX_SHELVES, MAX_QUEUE, "scan"),  # every limit at once
    (64, 128, 4, 64, 8, "scan"),  # 8,192 cells: no tile of 32 holds the map
    (40, 40, MAX_AGENTS, MAX_SHELVES, MAX_QUEUE, "shared"),  # a uint16 map in a tile
    (11, 10, MAX_AGENTS, MAX_QUEUE, MAX_QUEUE, "shared"),
])
def test_rollout_plan_at_the_limits(h, w, n, s, r, route):
    config = WarehouseConfig(layout=layout_str(h, w, s), n_agents=n, request_queue_size=r)
    assert config.compile_layout().n_shelves == s
    for batch in BATCHES:
        plan = rollout_plan(config, batch)
        check_plan(plan, config, batch)
        if route == "scan":
            assert plan.route == "scan"
        else:  # the tile in shared memory where two waves of tiles take the batch
            shared = rollout_plan(config, batch, route="shared")
            assert plan.route == ("shared" if shared.waves(batch) <= ROLLOUT_MAX_WAVES
                                  else "global")
        check_plan(rollout_plan(config, batch, route="scan"), config, batch)
        check_plan(rollout_plan(config, batch, route="global"), config, batch)
    if route == "scan":
        with pytest.raises(ValueError):
            rollout_plan(config, 1000, route="shared")
    build_fused_rollout(config, 4)  # the wrapper takes it too


def test_rollout_plan_refusals():
    config = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu").config
    with pytest.raises(ValueError):
        rollout_plan(config, 0)
    with pytest.raises(ValueError):
        rollout_plan(config, 100, route="tiles")
    roll = build_fused_rollout(config, 4)
    assert roll.plan(1000) == rollout_plan(config, 1000)
    roll.route = "scan"
    assert roll.plan(1000).route == "scan"


# --- K1's resolver in registers -------------------------------------------------


def masks_resolver(acell, tcell, k):
    """``resolve_moves_masks<K>`` of csrc/env_core.cuh, step for step on
    Python ints: the successor, predecessor and same-target masks, the peel
    for the cycles, the spread of the component flags, the depth levels and
    the chain rule's spread of the bad agents."""
    n = len(acell)
    all_ = (1 << n) - 1
    ac = list(acell) + [-1 - i for i in range(n, k)]
    tc = list(tcell) + [-1 - k - i for i in range(n, k)]
    S, T = [], []
    for i in range(k):
        hit = sum(1 << j for j in range(k) if tc[i] == ac[j])
        S.append(hit & -hit)
        T.append(sum(1 << j for j in range(k) if tc[i] == tc[j]))
    P = [sum(((S[i] >> j) & 1) << i for i in range(k)) for j in range(k)]
    on = all_
    for _ in range(n):
        on &= sum(int(bool(S[i] & on) and bool(P[i] & on)) << i for i in range(k))
    poison = sum(int(bool(S[i] & P[i]) and S[i] != 1 << i) << i for i in range(k))
    cyc = on
    for _ in range(n):
        for i in range(k):
            adj = T[i] | S[i] | P[i]
            poison |= int(bool(adj & poison)) << i
            cyc |= int(bool(adj & cyc)) << i
    level, depth = all_, [1] * k
    for _ in range(1, n):
        level = sum(int(bool(P[i] & level)) << i for i in range(k))
        for i in range(k):
            depth[i] += (level >> i) & 1
    bad = 0
    for i in range(k):
        ok = all(depth[j] < depth[i] or (depth[j] == depth[i] and j > i)
                 for j in range(k) if j != i and (T[i] >> j) & 1)
        bad |= int(not ok) << i
    for _ in range(n):
        for i in range(k):
            bad |= int(bool(S[i] & bad)) << i
    return [bool((on >> i) & 1 and not (poison >> i) & 1)
            or bool(not (bad >> i) & 1 and not (cyc >> i) & 1) for i in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_mask_resolver_rules_match_the_resolver(n):
    """K1 resolves its agents' moves on bitmasks in registers up to 16 agents;
    its rules give ``ops/resolver.resolve_moves``'s commits on random crowded
    grids (chains, cycles, head-on swaps, shared targets), padded to each K
    the kernel takes for n agents."""
    from rware_tpu_torch.ops.resolver import resolve_moves

    rng = np.random.default_rng(n)
    b, w = 400, 4 if n <= 8 else 5
    cells = np.stack([rng.choice(w * w, n, replace=False) for _ in range(b)])
    dirs = rng.integers(0, 5, size=(b, n))  # 4: stay
    dx, dy = np.array([0, 0, -1, 1, 0])[dirs], np.array([-1, 1, 0, 0, 0])[dirs]
    tx, ty = np.clip(cells % w + dx, 0, w - 1), np.clip(cells // w + dy, 0, w - 1)
    want = resolve_moves(*(torch.from_numpy(a.astype(np.int32))
                           for a in (cells % w, cells // w, tx, ty))).numpy()
    for k in {2, 4, 8, 16} & set(range(n, 17)):
        got = np.array([masks_resolver(cells[e].tolist(), (ty[e] * w + tx[e]).tolist(), k)
                        for e in range(b)])
        np.testing.assert_array_equal(got, want)
    assert want.mean() > 0 and (n == 1 or want.mean() < 1)  # one agent alone always moves


# --- the premise: no two shelves on one cell ------------------------------------


def shelves_apart(shelf_x, shelf_y, width) -> bool:
    """No two shelves of an env on one cell (arrays (B, S))."""
    cells = np.sort(np.asarray(shelf_y, dtype=np.int64) * width + np.asarray(shelf_x), axis=1)
    return bool((np.diff(cells, axis=1) > 0).all())


def random_actions(rng, shape, biased: bool) -> np.ndarray:
    """Uniform moves, or moves biased to forward and toggle (more shelves on
    the move)."""
    p = [0.1, 0.4, 0.15, 0.15, 0.2] if biased else None
    return rng.choice(5, size=shape, p=p).astype(np.int32)


def port_rollout_keeps_shelves_apart(config, b, steps, seed, state=None, actions_fn=None):
    """Step the port's plain engine one step a call (K1's plain version, a
    new seed each step) and check the premise after every step; returns the
    deliveries and episode ends seen."""
    roll1 = build_fused_rollout(config, 1, scripted=actions_fn is not None)
    w = config.compile_layout().grid_size[1]
    if state is None:
        state, _ = batched_reset(Warehouse(config, device="cpu"), seed, b)
    assert shelves_apart(state.shelf_x, state.shelf_y, w)
    reward = episodes = 0.0
    for t in range(steps):
        acts = None if actions_fn is None else actions_fn(t)[None]
        state, rew, epis = roll1(state, seed * 1000 + t, acts)
        reward += float(rew.sum())
        episodes += float(epis.sum())
        assert shelves_apart(state.shelf_x, state.shelf_y, w), f"two shelves on a cell at step {t}"
    return state, reward, episodes


@pytest.mark.parametrize("env_id", chip_smoke.K1_CONFIGS)
def test_random_plain_rollouts_keep_shelves_apart(env_id):
    config = dataclasses.replace(rware_tpu_torch.make(env_id, device="cpu").config,
                                 max_steps=40)
    _, _, episodes = port_rollout_keeps_shelves_apart(config, 256, 100, 3)
    assert episodes >= 256 * 2  # resets happened, twice an env


def loaded_state(config, b: int, seed: int):
    """B envs whose agents all stand on distinct highway cells, agent i
    carrying shelf i (its rack slot left empty)."""
    state, _ = batched_reset(Warehouse(config, device="cpu"), seed, b)
    layout = config.compile_layout()
    w = layout.grid_size[1]
    highway = np.flatnonzero(np.asarray(layout.highways).reshape(-1))
    rng = np.random.default_rng(seed)
    n = config.n_agents
    cells = np.stack([rng.choice(highway, n, replace=False) for _ in range(b)])
    ax = torch.from_numpy((cells % w).astype(np.int32))
    ay = torch.from_numpy((cells // w).astype(np.int32))
    sx, sy = state.shelf_x.clone(), state.shelf_y.clone()
    sx[:, :n], sy[:, :n] = ax, ay
    return dataclasses.replace(
        state, agent_x=ax, agent_y=ay,
        agent_carrying=torch.arange(n, dtype=torch.int32).repeat(b, 1), shelf_x=sx, shelf_y=sy)


@pytest.mark.parametrize("env_id", ["rware-tiny-16ag-v2", "rware-small-4ag-v2"])
def test_scripted_loaded_agents_keep_shelves_apart(env_id):
    """Every agent loaded, moving mostly forward and never toggling: loaded
    agents run head-on, in chains and into standing shelves."""
    config = dataclasses.replace(rware_tpu_torch.make(env_id, device="cpu").config,
                                 max_steps=None)
    b = 128
    state = loaded_state(config, b, 5)
    rng = np.random.default_rng(6)
    acts = rng.choice([FORWARD, TURN_LEFT, TURN_RIGHT, NOOP], size=(60, b, config.n_agents),
                      p=[0.6, 0.15, 0.15, 0.1]).astype(np.int32)
    final, _, _ = port_rollout_keeps_shelves_apart(
        config, b, 60, 7, state=state, actions_fn=lambda t: torch.from_numpy(acts[t]))
    assert (final.agent_carrying >= 0).all()  # nobody dropped a shelf
    moved = (final.agent_x != state.agent_x) | (final.agent_y != state.agent_y)
    assert float(moved.float().mean()) > 0.5


# tiny-4ag: a highway row at y=0 and columns x=0, 3-6, 9; racks at x=1-2 and
# 7-8, y=1-8; shelf slots 0-3 at (1,1), (2,1), (7,1), (8,1).
SCENES = {
    # two loaded agents head-on: the swap is poisoned, neither moves
    "head_on": ([(4, 0, RIGHT), (5, 0, LEFT), (0, 9, UP), (9, 9, UP)], [0, 1, -1, -1],
                [FORWARD, FORWARD, NOOP, NOOP], [(4, 0), (5, 0), (0, 9), (9, 9)]),
    # three loaded agents in a chain: each enters the cell the next leaves
    "chain": ([(3, 0, RIGHT), (4, 0, RIGHT), (5, 0, RIGHT), (9, 9, UP)], [0, 1, 2, -1],
              [FORWARD, FORWARD, FORWARD, NOOP], [(4, 0), (5, 0), (6, 0), (9, 9)]),
    # a loaded leader cancelled by a standing shelf holds up its loaded follower
    "blocked_chain": ([(0, 1, RIGHT), (0, 2, UP), (5, 5, UP), (9, 9, UP)], [2, 3, -1, -1],
                      [FORWARD, FORWARD, NOOP, NOOP], [(0, 1), (0, 2), (5, 5), (9, 9)]),
    # four loaded agents round a 2 x 2 square: the cycle commits, the shelves rotate
    "cycle": ([(3, 0, RIGHT), (4, 0, DOWN), (4, 1, LEFT), (3, 1, UP)], [0, 1, 2, 3],
              [FORWARD, FORWARD, FORWARD, FORWARD], [(4, 0), (4, 1), (3, 1), (3, 0)]),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scripted_scenes_keep_shelves_apart(scene):
    agents, carrying, acts, want = SCENES[scene]
    config = rware_tpu_torch.make("rware-tiny-4ag-v2", device="cpu").config
    state = make_state(config, agents, carrying=carrying)
    final, _, _ = port_rollout_keeps_shelves_apart(
        config, 1, 1, 0, state=state, actions_fn=lambda t: torch.tensor([acts], dtype=torch.int32))
    assert list(zip(final.agent_x[0].tolist(), final.agent_y[0].tolist())) == want
    for i, s in enumerate(carrying):
        if s >= 0:
            assert (int(final.shelf_x[0, s]), int(final.shelf_y[0, s])) == want[i]


@pytest.mark.parametrize("env_id", chip_smoke.K1_CONFIGS)
def test_jax_engine_keeps_shelves_apart(env_id):
    """The premise on the reference: the JAX package's XLA engine, uniform and
    biased random actions, autoreset every 20 steps."""
    config = dataclasses.replace(rware_tpu.parse_env_id(env_id), max_steps=20)
    b, steps = 64, 60
    reset = jax.vmap(jax_engine.build_reset_fn(config))
    step = jax.vmap(jax_engine.build_step_fn(config, obs_fn=lambda s: jnp.zeros(())))
    w = config.compile_layout().grid_size[1]

    @jax.jit
    def advance(state, acts, key):
        res = step(state, acts)
        fresh = reset(jax.random.split(key, b))
        pick = {f: jnp.where(res.done.reshape((b,) + (1,) * (getattr(fresh, f).ndim - 1)),
                             getattr(fresh, f), getattr(res.state, f))
                for f in ("agent_x", "agent_y", "agent_dir", "agent_carrying",
                          "agent_has_delivered", "agent_message", "shelf_x", "shelf_y",
                          "request_queue", "cur_steps", "cur_inactive_steps")}
        return res.state.replace(**pick), res.done

    rng = np.random.default_rng(1)
    for biased in (False, True):
        state = reset(jax.random.split(jax.random.key(int(biased)), b))
        ends = 0
        for t in range(steps):
            acts = jnp.asarray(random_actions(rng, (b, config.n_agents), biased))
            state, done = advance(state, acts, jax.random.key(100 * t + 1))
            ends += int(done.sum())
            assert shelves_apart(state.shelf_x, state.shelf_y, w), \
                f"two shelves on a cell at step {t} (biased={biased})"
        assert ends >= 2 * b
