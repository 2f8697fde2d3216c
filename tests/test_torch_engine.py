"""The port's engine (config, registry, state, resolver, step, observations)
against the JAX package on the same inputs.

Dynamics fields, rewards and observations must match the JAX XLA engine
exactly.  The request queue is resampled from different generators
(threefry there, explicit draws here), so it is checked by rule.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu import Action, RewardType
from rware_tpu.ops.resolver import resolve_moves as jax_resolve_moves
from rware_tpu.testing import make_state as jax_make_state
from rware_tpu_torch.convert import state_from_numpy, state_to_numpy
from rware_tpu_torch.core.engine import build_reset_fn, n_reset_draws
from rware_tpu_torch.ops.resolver import resolve_moves
from rware_tpu_torch.testing import DOWN, LEFT, RIGHT, UP, make_state, positions
from tests.torch_ref import (
    ALL_FIELDS,
    DYNAMICS_FIELDS,
    assert_fields_equal,
    check_queue_rule,
    cpu_generator,
    jax_states,
    make_pair,
    to_port,
)

torch.set_num_threads(1)

ENV_IDS = [
    "rware-tiny-2ag-v2",
    "rware-small-4ag-v2",
    "rware-medium-6ag-hard-v2",
    "rware-large-8ag-v2",
    "rware-tiny-16ag-v2",
    "rware-tiny-1ag-hard-v2",
    "rware-2s-tiny-2ag-v2",
    "rware-3x5-4h-3ag-easy-v2",
    "rware-small-4ag-12req-twostage-v2",
    "rware-img-tiny-2ag-global-v2",
    "rware-imgdict-Nd-3s-medium-4ag-indiv-v2",
]


# --- config, layout, registry ------------------------------------------------


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_parse_env_id_matches_jax(env_id):
    want = dataclasses.asdict(rware_tpu.parse_env_id(env_id))
    got = dataclasses.asdict(rware_tpu_torch.parse_env_id(env_id))
    assert got == want


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_compile_layout_matches_jax(env_id):
    jcfg, tcfg = rware_tpu.parse_env_id(env_id), rware_tpu_torch.parse_env_id(env_id)
    jl, tl = jcfg.compile_layout(), tcfg.compile_layout()
    assert tl.grid_size == jl.grid_size
    for f in ("highways", "goals", "shelf_slots"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f), err_msg=f)
    assert tcfg.flattened_obs_length == jcfg.flattened_obs_length
    assert tcfg.policy_obs_length == jcfg.policy_obs_length


def test_string_layout_and_bad_ids():
    layout = """
    ..x..
    .gxg.
    """
    jl = rware_tpu.WarehouseConfig(layout=layout, request_queue_size=1).compile_layout()
    tl = rware_tpu_torch.WarehouseConfig(layout=layout, request_queue_size=1).compile_layout()
    np.testing.assert_array_equal(tl.highways, jl.highways)
    np.testing.assert_array_equal(tl.goals, jl.goals)
    for bad in ("rware-huge-2ag-v2", "rware-Nd-tiny-2ag-v2", "rware-tiny-2ag-v1"):
        with pytest.raises(ValueError):
            rware_tpu_torch.parse_env_id(bad)
    with pytest.raises(ValueError):
        rware_tpu_torch.WarehouseConfig(request_queue_size=100)


def test_make_accepts_config_and_overrides():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", max_steps=7, device="cpu")
    assert env.config.max_steps == 7 and env.device == torch.device("cpu")
    env2 = rware_tpu_torch.make(env.config, device="cpu")
    assert env2.config == env.config
    msg = rware_tpu_torch.make("rware-tiny-2ag-v2", msg_bits=1, device="cpu")
    assert msg.config.msg_bits == 1 and msg.config.flattened_obs_length == 8 + 9 * (7 + 1)
    assert msg.reset(cpu_generator(0), 2)[1].shape == (2, 2, 80)


# --- state ----------------------------------------------------------------------


def test_state_converter_round_trip():
    jenv, _ = make_pair("rware-small-4ag-v2")
    jstate = jax_states(jenv, 16, seed=3)
    state = to_port(jstate)
    assert state.agent_x.dtype == torch.int32 and state.agent_has_delivered.dtype == torch.bool
    assert state.batch_size == 16 and state.n_agents == 4
    assert_fields_equal(state, jstate, ALL_FIELDS)
    again = state_from_numpy(state_to_numpy(state))
    for f, v in state_to_numpy(again).items():
        np.testing.assert_array_equal(v, state_to_numpy(state)[f])


def test_make_state_matches_jax():
    jenv, env = make_pair("rware-tiny-2ag-v2")
    args = ([(4, 9, DOWN), (0, 0, UP)],)
    kw = dict(carrying=[3, -1], queue=[3, 1], has_delivered=[True, False])
    assert_fields_equal(
        make_state(env.config, *args, **kw),
        jax_make_state(jenv.config, *args, **kw),
        ALL_FIELDS,
        batched=False,
    )


# --- resolver -----------------------------------------------------------------


@pytest.mark.parametrize("n_agents,grid", [(2, 3), (5, 4), (9, 4), (16, 6)])
def test_resolver_matches_jax_on_random_states(n_agents, grid):
    rng = np.random.default_rng(n_agents)
    b = 512
    cells = np.stack([rng.choice(grid * grid, n_agents, replace=False) for _ in range(b)])
    sx, sy = cells % grid, cells // grid
    d = rng.integers(0, 5, (b, n_agents))  # 4 = stay
    dx = np.array([0, 0, -1, 1, 0])[d]
    dy = np.array([-1, 1, 0, 0, 0])[d]
    tx = np.clip(sx + dx, 0, grid - 1).astype(np.int32)
    ty = np.clip(sy + dy, 0, grid - 1).astype(np.int32)
    sx, sy = sx.astype(np.int32), sy.astype(np.int32)
    want = jax.vmap(jax_resolve_moves)(*(jnp.asarray(a) for a in (sx, sy, tx, ty)))
    got = resolve_moves(*(torch.from_numpy(a) for a in (sx, sy, tx, ty)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- golden scenarios (tests/test_movement.py, tests/test_goals.py) ------------

OPEN = """
.....
.....
..x..
.....
....g
"""
RACK2 = """
.....
.x.x.
....g
"""
GOALS = """
.....
.xxx.
.....
.....
....g
"""
GOALS2 = """
.....
.xxx.
.....
.....
...gg
"""

FWD, NOOP, TOGGLE = int(Action.FORWARD), int(Action.NOOP), int(Action.TOGGLE_LOAD)
ROT_L, ROT_R = int(Action.LEFT), int(Action.RIGHT)


def _pos(*expected):
    return lambda res: positions(res[-1].state) == list(expected)


def _carrying(i, value):
    return lambda res: int(res[-1].state.agent_carrying[0, i]) == value


def _rewards(*values):
    return lambda res: res[-1].rewards[0].tolist() == list(values)


SCENARIOS = {
    # movement and wall clamps
    "forward_up": (dict(n_agents=1, layout=OPEN), [(1, 1, UP)], {}, [[FWD]], _pos((1, 0))),
    "forward_down": (dict(n_agents=1, layout=OPEN), [(1, 1, DOWN)], {}, [[FWD]], _pos((1, 2))),
    "forward_left": (dict(n_agents=1, layout=OPEN), [(1, 1, LEFT)], {}, [[FWD]], _pos((0, 1))),
    "forward_right": (dict(n_agents=1, layout=OPEN), [(1, 1, RIGHT)], {}, [[FWD]], _pos((2, 1))),
    "wall_up": (dict(n_agents=1, layout=OPEN), [(0, 0, UP)], {}, [[FWD]], _pos((0, 0))),
    "wall_left": (dict(n_agents=1, layout=OPEN), [(0, 0, LEFT)], {}, [[FWD]], _pos((0, 0))),
    "wall_down": (dict(n_agents=1, layout=OPEN), [(4, 4, DOWN)], {}, [[FWD]], _pos((4, 4))),
    "wall_right": (dict(n_agents=1, layout=OPEN), [(4, 4, RIGHT)], {}, [[FWD]], _pos((4, 4))),
    "rotate_left_from_right": (
        dict(n_agents=1, layout=OPEN), [(2, 2, RIGHT)], {}, [[ROT_L]],
        lambda res: int(res[-1].state.agent_dir[0, 0]) == int(UP),
    ),
    "rotate_right_from_left": (
        dict(n_agents=1, layout=OPEN), [(2, 2, LEFT)], {}, [[ROT_R]],
        lambda res: int(res[-1].state.agent_dir[0, 0]) == int(UP),
    ),
    # collisions
    "head_on_swap": (
        dict(n_agents=2, layout=OPEN), [(1, 1, RIGHT), (2, 1, LEFT)], {}, [[FWD, FWD]],
        _pos((1, 1), (2, 1)),
    ),
    "head_on_swap_poisons_component": (
        dict(n_agents=3, layout=OPEN), [(1, 1, RIGHT), (2, 1, LEFT), (0, 1, RIGHT)], {},
        [[FWD] * 3], _pos((1, 1), (2, 1), (0, 1)),
    ),
    "into_static_agent": (
        dict(n_agents=2, layout=OPEN), [(1, 1, RIGHT), (2, 1, UP)], {}, [[FWD, NOOP]],
        _pos((1, 1), (2, 1)),
    ),
    "into_rotating_agent": (
        dict(n_agents=2, layout=OPEN), [(1, 1, RIGHT), (2, 1, UP)], {}, [[FWD, ROT_L]],
        _pos((1, 1), (2, 1)),
    ),
    "chain_of_two": (
        dict(n_agents=2, layout=OPEN), [(1, 1, RIGHT), (2, 1, RIGHT)], {}, [[FWD, FWD]],
        _pos((2, 1), (3, 1)),
    ),
    "chain_of_three": (
        dict(n_agents=3, layout=OPEN), [(0, 1, RIGHT), (1, 1, RIGHT), (2, 1, RIGHT)], {},
        [[FWD] * 3], _pos((1, 1), (2, 1), (3, 1)),
    ),
    "chain_blocked_by_head": (
        dict(n_agents=3, layout=OPEN), [(0, 1, RIGHT), (1, 1, RIGHT), (2, 1, RIGHT)], {},
        [[FWD, FWD, NOOP]], _pos((0, 1), (1, 1), (2, 1)),
    ),
    "four_cycle": (
        dict(n_agents=4, layout=OPEN), [(1, 1, RIGHT), (2, 1, DOWN), (2, 2, LEFT), (1, 2, UP)],
        {}, [[FWD] * 4], _pos((2, 1), (2, 2), (1, 2), (1, 1)),
    ),
    "cycle_feeder_fails": (
        dict(n_agents=5, layout=OPEN),
        [(1, 1, RIGHT), (2, 1, DOWN), (2, 2, LEFT), (1, 2, UP), (0, 1, RIGHT)], {},
        [[FWD] * 5], _pos((2, 1), (2, 2), (1, 2), (1, 1), (0, 1)),
    ),
    "longer_chain_wins": (
        dict(n_agents=3, layout=OPEN), [(1, 1, RIGHT), (2, 1, RIGHT), (3, 2, UP)], {},
        [[FWD] * 3], _pos((2, 1), (3, 1), (3, 2)),
    ),
    "equal_chains_lowest_index_wins": (
        dict(n_agents=2, layout=OPEN), [(2, 1, DOWN), (2, 3, UP)], {}, [[FWD, FWD]],
        _pos((2, 2), (2, 3)),
    ),
    # carrying
    "pickup_and_carry": (
        dict(n_agents=1, layout=OPEN), [(2, 2, UP)], {}, [[TOGGLE], [FWD]],
        lambda res: positions(res[-1].state) == [(2, 1)]
        and res[-1].state.shelf_x[0, 0] == 2 and res[-1].state.shelf_y[0, 0] == 1,
    ),
    "toggle_on_empty_cell": (
        dict(n_agents=1, layout=OPEN), [(0, 0, UP)], {}, [[TOGGLE]], _carrying(0, -1),
    ),
    "drop_on_highway_fails": (
        dict(n_agents=1, layout=OPEN), [(1, 1, UP)], dict(carrying=[0]), [[TOGGLE]],
        _carrying(0, 0),
    ),
    "drop_off_highway": (
        dict(n_agents=1, layout=OPEN), [(2, 2, UP)], dict(carrying=[0]), [[TOGGLE]],
        _carrying(0, -1),
    ),
    "unloaded_under_shelf": (
        dict(n_agents=1, layout=OPEN), [(2, 3, UP)], {}, [[FWD]], _pos((2, 2)),
    ),
    "loaded_pre_cancel": (
        dict(n_agents=1, layout=RACK2), [(2, 1, RIGHT)], dict(carrying=[0]), [[FWD]],
        _pos((2, 1)),
    ),
    "loaded_follows_loaded": (
        dict(n_agents=2, layout=RACK2), [(2, 1, RIGHT), (3, 1, RIGHT)],
        dict(carrying=[0, 1]), [[FWD, FWD]], _pos((3, 1), (4, 1)),
    ),
    "loaded_head_on_swap": (
        dict(n_agents=2, layout=RACK2), [(1, 0, RIGHT), (2, 0, LEFT)],
        dict(carrying=[0, 1]), [[FWD, FWD]], _pos((1, 0), (2, 0)),
    ),
    "rotate_while_carrying": (
        dict(n_agents=1, layout=OPEN), [(2, 2, UP)], dict(carrying=[0]), [[ROT_R]],
        lambda res: int(res[-1].state.agent_dir[0, 0]) == int(RIGHT),
    ),
    # deliveries, rewards, termination
    "delivery_individual": (
        dict(n_agents=2, layout=GOALS), [(4, 3, DOWN), (0, 0, UP)],
        dict(carrying=[0, -1], queue=[0]), [[FWD, NOOP]], _rewards(1.0, 0.0),
    ),
    "delivery_global": (
        dict(n_agents=2, layout=GOALS, reward_type=RewardType.GLOBAL),
        [(4, 3, DOWN), (0, 0, UP)], dict(carrying=[0, -1], queue=[0]), [[FWD, NOOP]],
        _rewards(1.0, 1.0),
    ),
    "delivery_two_stage": (
        dict(n_agents=2, layout=GOALS, reward_type=RewardType.TWO_STAGE),
        [(4, 3, DOWN), (0, 0, UP)], dict(carrying=[0, -1], queue=[0]),
        [[FWD, NOOP], (lambda s: s.set_agent(0, x=1, y=1), [TOGGLE, NOOP])],
        lambda res: res[0].rewards[0].tolist() == [0.5, 0.0]
        and res[1].rewards[0].tolist() == [0.5, 0.0]
        and not bool(res[1].state.agent_has_delivered[0, 0]),
    ),
    "two_stage_drop_without_delivery": (
        dict(n_agents=2, layout=GOALS, reward_type=RewardType.TWO_STAGE),
        [(1, 1, UP), (0, 0, UP)], dict(carrying=[0, -1], queue=[0]), [[TOGGLE, NOOP]],
        _rewards(0.0, 0.0),
    ),
    "non_requested_shelf_on_goal": (
        dict(n_agents=2, layout=GOALS), [(4, 3, DOWN), (0, 0, UP)],
        dict(carrying=[2, -1], queue=[0]), [[FWD, NOOP]],
        lambda res: res[-1].rewards[0].tolist() == [0.0, 0.0]
        and int(res[-1].state.cur_inactive_steps[0]) == 1,
    ),
    "unloaded_agent_on_goal": (
        dict(n_agents=2, layout=GOALS), [(4, 3, DOWN), (0, 0, UP)], dict(queue=[0]),
        [[FWD, NOOP]], _rewards(0.0, 0.0),
    ),
    "queue_resample_excludes_queued": (
        dict(n_agents=2, layout=GOALS, request_queue_size=2), [(4, 3, DOWN), (0, 0, UP)],
        dict(carrying=[0, -1], queue=[0, 1]), [[FWD, NOOP]],
        lambda res: res[-1].state.request_queue[0].tolist() == [2, 1],
    ),
    "inactivity_termination": (
        dict(n_agents=1, layout=GOALS, max_inactivity_steps=5, max_steps=None),
        [(0, 0, UP)], {}, [[NOOP]] * 5,
        lambda res: [bool(r.done[0]) for r in res] == [False] * 4 + [True],
    ),
    "max_steps_termination": (
        dict(n_agents=1, layout=GOALS, max_steps=3), [(0, 0, UP)], {}, [[NOOP]] * 3,
        lambda res: [bool(r.done[0]) for r in res] == [False, False, True]
        and not bool(res[-1].truncated[0]),
    ),
    "delivery_resets_inactivity": (
        dict(n_agents=2, layout=GOALS), [(4, 3, DOWN), (0, 0, UP)],
        dict(carrying=[0, -1], queue=[0]),
        [(lambda s: s.replace(cur_inactive_steps=s.cur_inactive_steps + 99), [FWD, NOOP])],
        lambda res: int(res[-1].state.cur_inactive_steps[0]) == 0,
    ),
    "two_goals_deliver_together": (
        dict(n_agents=2, layout=GOALS2, request_queue_size=3), [(3, 3, DOWN), (4, 3, DOWN)],
        dict(carrying=[0, 1], queue=[0, 1, 2]), [[FWD, FWD]],
        lambda res: res[-1].rewards[0].tolist() == [1.0, 1.0]
        and int(res[-1].info["deliveries"][0]) == 2,
    ),
    "queue_equals_shelf_count": (
        dict(n_agents=2, layout=GOALS, request_queue_size=3), [(4, 3, DOWN), (0, 0, UP)],
        dict(carrying=[0, -1], queue=[0, 1, 2]), [[FWD, NOOP]],
        lambda res: sorted(res[-1].state.request_queue[0].tolist()) == [0, 1, 2],
    ),
}


@functools.lru_cache(maxsize=None)
def _jax_env(config):
    """One JAX env per config, so scenarios sharing a config share its
    compiled step."""
    return rware_tpu.make(config)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_golden_scenario_matches_jax(name):
    cfg_kw, agents, state_kw, steps, expect = SCENARIOS[name]
    cfg_kw = {"request_queue_size": 1, **cfg_kw}
    jenv = _jax_env(rware_tpu.WarehouseConfig(**cfg_kw))
    env = rware_tpu_torch.make(rware_tpu_torch.WarehouseConfig(**cfg_kw), device="cpu")
    jstate = jax_make_state(jenv.config, agents, **state_kw)
    state = make_state(env.config, agents, **state_kw)
    gen = cpu_generator(0)
    results = []
    for step in steps:
        prep, acts = step if isinstance(step, tuple) else (None, step)
        if prep is not None:
            jstate, state = prep(jstate), prep(state)
        jres = jenv.step(jstate, jnp.asarray(acts, dtype=jnp.int32))
        res = env.step(state, torch.tensor([acts], dtype=torch.int32), gen)
        assert_fields_equal(res.state, jres.state, DYNAMICS_FIELDS, batched=False)
        np.testing.assert_array_equal(res.rewards[0].numpy(), np.asarray(jres.rewards))
        np.testing.assert_array_equal(res.obs[0].numpy(), np.asarray(jres.obs))
        assert bool(res.done[0]) == bool(jres.done)
        assert int(res.info["deliveries"][0]) == int(jres.info["deliveries"])
        assert int(res.info["failed_moves"][0]) == int(jres.info["failed_moves"])
        check_queue_rule(
            state.request_queue[0], jres.state.request_queue, res.state.request_queue[0],
            env.layout.n_shelves,
        )
        results.append(res)
        jstate = jres.state
        # lockstep: carry JAX's queue on (the draws differ by design)
        state = res.state.replace(
            request_queue=torch.from_numpy(np.array(jres.state.request_queue))[None]
        )
    assert expect(results), name


# --- batched steps vs the JAX engine -------------------------------------------


@pytest.mark.parametrize(
    "env_id",
    ["rware-tiny-2ag-v2", "rware-small-4ag-v2", "rware-medium-6ag-hard-v2"],
)
def test_step_lockstep_with_jax(env_id):
    """T=12 random actions (toggles and forwards favoured, to reach
    deliveries) from 256 JAX resets: each step starts both engines from the
    same state; dynamics, rewards, obs and done must be equal."""
    jenv, env = make_pair(env_id)
    b, t_len = 256, 12
    jstate = jax_states(jenv, b, seed=1)
    rng = np.random.default_rng(2)
    acts = rng.choice(5, size=(t_len, b, env.n_agents), p=[0.1, 0.4, 0.1, 0.1, 0.3])
    jstep = jax.jit(jax.vmap(jenv._step_fn))
    gen = cpu_generator(5)
    for t in range(t_len):
        jres = jstep(jstate, jnp.asarray(acts[t], dtype=jnp.int32))
        state = to_port(jstate)
        res = env.step(state, torch.from_numpy(acts[t]), gen)
        assert_fields_equal(res.state, jres.state)
        np.testing.assert_array_equal(res.rewards.numpy(), np.asarray(jres.rewards))
        np.testing.assert_array_equal(res.obs.numpy(), np.asarray(jres.obs))
        np.testing.assert_array_equal(res.done.numpy(), np.asarray(jres.done))
        check_queue_rule(
            state.request_queue, jres.state.request_queue, res.state.request_queue,
            env.layout.n_shelves,
        )
        jstate = jres.state


# --- observations ----------------------------------------------------------------


@pytest.mark.parametrize(
    "overrides",
    [{}, {"sensor_range": 2}, {"normalised_coordinates": True, "n_agents": 4}],
)
def test_flattened_obs_bit_exact(overrides):
    cfg = dataclasses.replace(rware_tpu.parse_env_id("rware-small-2ag-v2"), **overrides)
    jenv, env = make_pair(cfg)
    b = 128
    jstate = jax_states(jenv, b, seed=4)
    rng = np.random.default_rng(0)
    jstep = jax.jit(jax.vmap(jenv._step_fn))
    for _ in range(6):  # move agents and shelves off their spawn cells
        acts = rng.choice(5, size=(b, cfg.n_agents), p=[0.1, 0.4, 0.2, 0.1, 0.2])
        jstate = jstep(jstate, jnp.asarray(acts, dtype=jnp.int32)).state
    want = jax.vmap(jenv._obs_fn)(jstate)
    got = env.observe(to_port(jstate))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- reset and the facade -----------------------------------------------------------


def test_reset_draws_and_scripted_respawn():
    env = rware_tpu_torch.make("rware-small-4ag-v2", device="cpu")
    reset = build_reset_fn(env.config)
    zeros = reset(torch.zeros((3, n_reset_draws(env.config)), dtype=torch.int64))
    w = env.grid_size[1]
    assert (zeros.agent_y * w + zeros.agent_x).tolist() == [[0, 1, 2, 3]] * 3
    assert zeros.agent_dir.eq(int(UP)).all()
    assert zeros.request_queue.tolist() == [[0, 1, 2, 3]] * 3
    state, obs = env.reset(cpu_generator(1), 64)
    cells = state.agent_y * w + state.agent_x
    assert (cells.sort(dim=1).values.diff(dim=1) > 0).all()
    assert (state.request_queue.sort(dim=1).values.diff(dim=1) > 0).all()
    assert obs.shape == (64, 4, env.config.flattened_obs_length)


def test_step_autoreset_replaces_finished_envs():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", max_steps=2, device="cpu")
    gen = cpu_generator(2)
    state, _ = env.reset(gen, 32)
    state = state.replace(cur_steps=torch.arange(32, dtype=torch.int32) % 2)
    acts = env.sample_actions(gen, 32)
    res = env.step_autoreset(state, acts, gen)
    done = res.done
    assert done.tolist() == [bool(i % 2) for i in range(32)]
    assert res.state.cur_steps[done].eq(0).all() and res.state.cur_steps[~done].eq(1).all()
    np.testing.assert_array_equal(res.obs.numpy(), env.observe(res.state).numpy())
