"""The port's invariant checks against the JAX package's
(``tests/test_debug.py``): the same messages on the same states, each with
its env index, and ``checked_step`` raising where JAX's checkify does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu.debug as jax_debug
import rware_tpu_torch
from rware_tpu.testing import DOWN, LEFT, RIGHT, UP
from rware_tpu.testing import make_state as jax_make_state
from rware_tpu_torch import debug
from rware_tpu_torch.core.state import WarehouseState, state_field_names
from tests.torch_ref import cpu_generator, make_pair, to_port

torch.set_num_threads(1)


def cat_states(states):
    return WarehouseState(**{f: torch.cat([getattr(s, f) for s in states])
                             for f in state_field_names()})


def test_valid_state_passes():
    jenv, env = make_pair("rware-tiny-2ag-v2")
    state, _ = jenv.reset(jax.random.key(0))
    jax_debug.validate_state(state, jenv.config)
    debug.validate_state(to_port(state, batched=False), env.config)
    states, _ = env.reset(cpu_generator(0), 256)
    debug.validate_state(states, env.config)
    assert debug.state_invariant_errors(states, env.config) == []


# (name, make_state kwargs, a change after make_state) of broken one-env states
BROKEN = {
    "agent_overlap": (dict(agents=[(1, 1, UP), (1, 1, UP)]), None),
    "carried_shelf_drift": (dict(agents=[(1, 1, UP), (2, 2, UP)], carrying=[0, -1]),
                            lambda s: s.set_agent(0, x=5)),
    "queue_duplicates": (dict(agents=[(1, 1, UP), (2, 2, UP)], queue=[3, 3]), None),
    "queue_out_of_range": (dict(agents=[(1, 1, UP), (2, 2, UP)], queue=[3, 99]), None),
    "agent_out_of_bounds": (dict(agents=[(-1, 1, UP), (2, 11, DOWN)]), None),
    "shelf_out_of_bounds_and_shared": (
        dict(agents=[(1, 1, UP), (2, 2, UP)],
             shelves=[(3, 1), (3, 1)] + [(4 + k % 5, 1 + k // 5) for k in range(20)]
             + [(99, 0), (0, -4)] + [(4 + k % 5, 6 + k // 5) for k in range(8)]), None),
    "carrying_out_of_range": (dict(agents=[(1, 1, UP), (2, 2, UP)]),
                              lambda s: s.replace(agent_carrying=s.agent_carrying.at[1].set(-2))),
    "shelf_carried_twice": (dict(agents=[(1, 1, LEFT), (1, 1, RIGHT)], carrying=[4, 4]), None),
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_invariant_messages_match_jax(case):
    """A batch of a valid env, the broken one, and a valid env: the broken
    env's messages are JAX's, with its index."""
    jenv, env = make_pair("rware-tiny-2ag-v2")
    kwargs, change = BROKEN[case]
    jstate = jax_make_state(jenv.config, **kwargs)
    if change is not None:
        jstate = change(jstate)
    want = jax_debug.state_invariant_errors(jstate, jenv.config)
    assert want, case
    valid, _ = env.reset(cpu_generator(1), 2)
    states = cat_states([valid.map(lambda t: t[:1]),
                         to_port(jstate, batched=False), valid.map(lambda t: t[1:])])
    got = debug.state_invariant_errors(states, env.config)
    assert got == [f"env 1: {m}" for m in want]
    with pytest.raises(ValueError, match="invalid WarehouseState: env 1: "):
        debug.validate_state(states, env.config)
    with pytest.raises(ValueError):
        jax_debug.validate_state(jstate, jenv.config)


def test_detects_agent_overlap():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    from rware_tpu_torch.testing import make_state

    state = make_state(env.config, [(1, 1, UP), (1, 1, UP)])
    errs = debug.state_invariant_errors(state, env.config)
    assert any("share a cell" in e for e in errs)
    with pytest.raises(ValueError):
        debug.validate_state(state, env.config)


def test_random_walks_stay_valid():
    """Every state of a random walk of the port's engine passes, as JAX's
    host check passes its states."""
    env = rware_tpu_torch.make("rware-small-4ag-v2", device="cpu")
    gen = cpu_generator(3)
    states, _ = env.reset(gen, 128)
    for _ in range(30):
        res = env.step_autoreset(states, env.sample_actions(gen, 128), gen)
        states = res.state
        assert debug.state_invariant_errors(states, env.config) == []


def test_checked_step_passes_on_valid():
    jenv, env = make_pair("rware-tiny-2ag-v2")
    state, _ = jenv.reset(jax.random.key(0))
    jchecked = jax.jit(jax_debug.checked_step(jenv._step_fn, jenv.config))
    jerr, jres = jchecked(state, jnp.asarray([1, 1], dtype=jnp.int32))
    jerr.throw()  # no violation
    checked = debug.checked_step(env.step, env.config)
    err, res = checked(to_port(state, batched=False), torch.tensor([[1, 1]], dtype=torch.int32),
                       cpu_generator(0))
    err.throw()  # no violation
    assert err.get() is None
    assert res.obs.shape == (1, 2, 71)
    np.testing.assert_array_equal(res.obs[0].numpy(), np.asarray(jres.obs))


def _teleport(state, i, x, y):
    """Move agent i (and nothing it carries) without a step."""
    return state.replace(agent_x=state.agent_x.at[i].set(x), agent_y=state.agent_y.at[i].set(y))


# broken states that a NOOP step carries through, and JAX's message for each
BROKEN_STEP = {
    "two agents share a cell after step": lambda s: _teleport(s, 1, 1, 1),
    "carried shelf not under its carrier": lambda s: _teleport(s, 0, 0, 0),
}


@pytest.mark.parametrize("message", list(BROKEN_STEP))
def test_checked_step_raises_where_jax_does(message):
    jenv, env = make_pair("rware-tiny-2ag-v2")
    jstate = BROKEN_STEP[message](
        jax_make_state(jenv.config, [(1, 1, UP), (2, 2, UP)], carrying=[0, -1]))
    jchecked = jax.jit(jax_debug.checked_step(jenv._step_fn, jenv.config))
    jerr, _ = jchecked(jstate, jnp.asarray([0, 0], dtype=jnp.int32))
    with pytest.raises(Exception, match=message):
        jerr.throw()
    valid, _ = env.reset(cpu_generator(2), 3)
    states = cat_states([valid.map(lambda t: t[:2]), to_port(jstate, batched=False)])
    err, res = debug.checked_step(env._step_fn, env.config)(
        states, torch.zeros((3, 2), dtype=torch.int32))
    assert err.get() == f"{message} (envs [2])"
    with pytest.raises(debug.CheckError, match=message):
        err.throw()
