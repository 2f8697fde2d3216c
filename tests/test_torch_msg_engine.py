"""Message bits (``msg_bits`` M > 0) in the port's env and in the fused
rollout's plain version (K1), against the JAX package on the CPU.

Every agent broadcasts M bits: the action is ``(N, 1 + M)``, the move in
column 0 and the bits after; they become the agent's message at every step
(``rware/warehouse.py:809-814``), every observation shows the message of the
agent on each window cell, and an episode's end clears them.  The same
numpy-seeded states, messages and actions go through both sides; dynamics,
messages, rewards and observations must agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, build_pallas_rollout
from rware_tpu_torch.ops.fused_rollout import build_fused_rollout, pack_state, unpack_state
from rware_tpu_torch.parallel import batched_reset, build_batched_rollout_fn
from rware_tpu_torch.testing import make_state
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

MSG_FIELDS = DYNAMICS_FIELDS + ("agent_message",)
# (env id, msg_bits, overrides): the three widths on three geometries
CASES = [("rware-tiny-2ag-v2", 1, {}), ("rware-small-4ag-v2", 2, {}),
         ("rware-tiny-2ag-v2", 3, {"sensor_range": 2})]


def _pair(env_id, m, **overrides):
    return make_pair(rware_tpu.make(env_id, msg_bits=m, **overrides).config)


def _actions(rng, shape, m):
    """(..., N, 1 + M) int32: moves favouring forwards and toggles, random bits."""
    moves = rng.choice(5, size=shape, p=[0.1, 0.4, 0.1, 0.1, 0.3])
    return np.concatenate([moves[..., None], rng.integers(0, 2, shape + (m,))],
                          axis=-1).astype(np.int32)


@pytest.mark.parametrize("env_id,m,overrides", CASES)
def test_obs_with_messages_bit_exact(env_id, m, overrides):
    """Observations of states holding random messages: 8 + W2 * (7 + M)
    features, the bits of the agent on a cell after its direction."""
    jenv, env = _pair(env_id, m, **overrides)
    jstate = jax_states(jenv, 128, seed=4)
    rng = np.random.default_rng(0)
    msg = rng.integers(0, 2, (128, env.n_agents, m)).astype(np.float32)
    jstate = jstate.replace(agent_message=jnp.asarray(msg))
    want = np.asarray(jax.vmap(jenv._obs_fn)(jstate))
    got = env.observe(to_port(jstate))
    w2 = (2 * env.config.sensor_range + 1) ** 2
    assert got.shape == want.shape == (128, env.n_agents, 8 + w2 * (7 + m))
    np.testing.assert_array_equal(got.numpy(), want)
    # the observing agent sees its own message in the centre cell
    centre = 8 + (w2 // 2) * (7 + m) + 5
    np.testing.assert_array_equal(got[..., centre:centre + m].numpy(), msg)


@pytest.mark.parametrize("env_id,m,overrides", CASES)
def test_step_lockstep_with_jax(env_id, m, overrides):
    """T=10 steps of scripted (B, N, 1 + M) actions from 256 JAX resets, each
    step from the same state on both engines: dynamics, messages, rewards,
    observations and done equal."""
    jenv, env = _pair(env_id, m, **overrides)
    b, t_len = 256, 10
    jstate = jax_states(jenv, b, seed=1)
    acts = _actions(np.random.default_rng(2), (t_len, b, env.n_agents), m)
    jstep = jax.jit(jax.vmap(jenv._step_fn))
    gen = cpu_generator(5)
    for t in range(t_len):
        jres = jstep(jstate, jnp.asarray(acts[t]))
        state = to_port(jstate)
        res = env.step(state, torch.from_numpy(acts[t]), gen)
        assert_fields_equal(res.state, jres.state, MSG_FIELDS)
        np.testing.assert_array_equal(res.state.agent_message.numpy(), acts[t][..., 1:])
        np.testing.assert_array_equal(res.rewards.numpy(), np.asarray(jres.rewards))
        np.testing.assert_array_equal(res.obs.numpy(), np.asarray(jres.obs))
        np.testing.assert_array_equal(res.done.numpy(), np.asarray(jres.done))
        check_queue_rule(state.request_queue, jres.state.request_queue,
                         res.state.request_queue, env.layout.n_shelves)
        jstate = jres.state


@pytest.mark.parametrize("m", [1, 2])
def test_k1_scripted_plain_matches_pallas(m):
    """K1's plain version against ``build_pallas_rollout(scripted=True,
    interpret=True)`` with (T, B, N, 1 + M) actions, as
    ``tests/test_pallas.py:133`` runs it; episodes of 4 steps end inside the
    rollout, so messages are cleared and set again."""
    jenv, env = _pair("rware-tiny-2ag-v2", m, max_steps=4)
    t_len = 6
    jstate = jax_states(jenv, ENV_BLOCK, seed=0)
    acts = _actions(np.random.default_rng(3), (t_len, ENV_BLOCK, 2), m)
    jroll = build_pallas_rollout(jenv.config, t_len, scripted=True, interpret=True)
    jfinal, jrew, jepis = jroll(jstate, 0, jnp.asarray(acts))
    roll = build_fused_rollout(env.config, t_len, scripted=True)
    final, rew, epis = roll(to_port(jstate), 0, torch.from_numpy(acts))
    assert roll.launches == 0  # CPU tensors take the plain version
    assert_fields_equal(final, jfinal, ALL_FIELDS + ("agent_message",))
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(epis.numpy(), np.asarray(jepis))
    assert int(epis.min()) == 1  # every env ended an episode at step 4
    np.testing.assert_array_equal(final.agent_message.numpy(), acts[-1][..., 1:])


def test_autoreset_clears_messages():
    """An episode's end clears every agent's message (the reset state's
    zeros), in ``step_autoreset`` and in K1's plain version; random-mode K1
    draws the bits uniformly (``rand_mod(draw, 2)``, purpose MESSAGE)."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", msg_bits=2, max_steps=3, device="cpu")
    gen = cpu_generator(0)
    state, obs = env.reset(gen, 64)
    assert state.agent_message.shape == (64, 2, 2) and not state.agent_message.any()
    ones = torch.ones((64, 2, 3), dtype=torch.int32)
    for t in range(3):
        res = env.step_autoreset(state, ones, gen)
        state = res.state
        assert bool(res.done.all()) == (t == 2)
        assert bool(state.agent_message.eq(0.0 if t == 2 else 1.0).all())
    np.testing.assert_array_equal(res.obs.numpy(), env.observe(res.state).numpy())
    states, _ = batched_reset(env, 1, 4096)
    for t_len, cleared in ((3, True), (2, False)):
        final, _, _ = build_fused_rollout(env.config, t_len)(states, 9)
        if cleared:
            assert not final.agent_message.any()
        else:
            assert abs(float(final.agent_message.mean()) - 0.5) < 0.02


def test_sample_actions_state_helpers_and_random_policy():
    env = rware_tpu_torch.make("rware-small-4ag-v2", msg_bits=3, device="cpu")
    acts = env.sample_actions(cpu_generator(1), 32)
    assert acts.shape == (32, 4, 4) and acts.dtype == torch.int32
    assert bool(((acts[..., 0] >= 0) & (acts[..., 0] < 5)).all())
    assert bool(((acts[..., 1:] == 0) | (acts[..., 1:] == 1)).all())
    msg = [[1, 0, 1], [0, 0, 0], [1, 1, 1], [0, 1, 0]]
    one = make_state(env.config, [(0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0)],
                     agent_message=msg)
    assert one.agent_message.tolist() == [msg]
    back = unpack_state(pack_state(one), one)
    for f in ALL_FIELDS + ("agent_message",):
        assert torch.equal(getattr(back, f), getattr(one, f)), f
    states, _ = batched_reset(env, 2, 16)
    rollout = build_batched_rollout_fn(env, n_steps=5)
    final, traj = rollout(states, 7)
    assert traj.actions.shape == (5, 16, 4, 4)
    assert torch.equal(final.agent_message, traj.actions[-1][..., 1:].float()
                       .where(~traj.dones[-1][:, None, None], torch.zeros(())))
