"""The fused collector kernel's plain version (K2a) against the JAX Pallas
collector, run as its own tests run it: ``interpret=True``,
``deterministic=True`` (argmax actions, scripted env draws) at
B = ENV_BLOCK, with parameters converted from one flax ``ActorCritic.init``.

Observations must match bit for bit; value and logp within 2e-2 (bf16
hidden layers); actions equal except where the top two logits are closer
than that.  The CUDA kernel runs only on a GPU (``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu_torch
from rware_tpu.models import ActorCritic as FlaxActorCritic
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, build_pallas_collect
from rware_tpu_torch.convert import actor_critic_from_flax
from rware_tpu_torch.models import ActorCritic
from rware_tpu_torch.ops.fused_rollout import build_fused_collect
from rware_tpu_torch.parallel import batched_reset
from tests.torch_ref import jax_states, make_pair, to_port

torch.set_num_threads(1)

ATOL = 2e-2
T_LEN = 16


def _run_pair(env_id, t_len, tc_len, seed=1):
    jenv, env = make_pair(env_id)
    states = jax_states(jenv, ENV_BLOCK, seed=0)
    model = FlaxActorCritic(n_actions=5)
    obs_dim = jenv.config.flattened_obs_length
    params = model.init(jax.random.key(seed), jnp.zeros((1, 2, obs_dim)))
    pallas = build_pallas_collect(
        jenv.config, t_len, tc_len=tc_len, interpret=True, deterministic=True
    )
    jnew, jtraj = pallas(states, params, 3)
    policy = actor_critic_from_flax(jax.tree.map(np.asarray, params))
    collect = build_fused_collect(env.config, t_len, deterministic=True)
    new, traj = collect(to_port(states), policy, 3)
    assert collect.launches == 0  # CPU tensors take the plain version
    return jenv, states, model, params, (jnew, jtraj), (new, traj)


def _assert_obs_equal_while_in_lockstep(traj, jtraj):
    """Obs bit-exact at every step of every env whose actions agreed at all
    earlier steps (a near-tie flip, allowed below, forks that env)."""
    got = traj["obs"].float().numpy()
    want = np.asarray(jtraj["obs"], dtype=np.float32)
    same = (traj["action"].numpy() == np.asarray(jtraj["action"])).all(-1)  # (T, B)
    lockstep = np.concatenate([np.ones_like(same[:1]), np.cumprod(same, 0)[:-1]], 0) > 0
    assert lockstep[-1].mean() > 0.99
    np.testing.assert_array_equal(got[lockstep], want[lockstep])


@pytest.fixture(scope="module")
def tiny_pair():
    return _run_pair("rware-tiny-2ag-v2", T_LEN, 8)


def test_trajectory_layout(tiny_pair):
    *_, (new, traj) = tiny_pair
    b, n, l_obs = ENV_BLOCK, 2, 71
    want = {
        "obs": ((T_LEN, b, n, l_obs), torch.bfloat16),
        "action": ((T_LEN, b, n), torch.int32),
        "logp": ((T_LEN, b, n), torch.float32),
        "value": ((T_LEN, b, n), torch.float32),
        "reward": ((T_LEN, b, n), torch.float32),
        "done": ((T_LEN, b), torch.bool),
    }
    assert set(traj) == set(want)
    for k, (shape, dtype) in want.items():
        assert tuple(traj[k].shape) == shape and traj[k].dtype == dtype, k


def test_obs_bit_exact_vs_pallas(tiny_pair):
    *_, (jnew, jtraj), (new, traj) = tiny_pair
    _assert_obs_equal_while_in_lockstep(traj, jtraj)


def test_value_logp_actions_vs_pallas(tiny_pair):
    jenv, states, model, params, (jnew, jtraj), (new, traj) = tiny_pair
    np.testing.assert_allclose(traj["value"].numpy(), np.asarray(jtraj["value"]), atol=ATOL)
    np.testing.assert_allclose(traj["logp"].numpy(), np.asarray(jtraj["logp"]), atol=ATOL)
    # Where the actions agree the trajectories stay in lockstep; a flip is
    # allowed only where flax's top two logits are closer than ATOL.
    logits, _ = model.apply(params, jnp.asarray(np.asarray(jtraj["obs"], dtype=np.float32)))
    top2 = np.sort(np.asarray(logits), -1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= ATOL
    differ = traj["action"].numpy() != np.asarray(jtraj["action"])
    assert not (differ & ~near_tie).any()
    assert differ.mean() <= 3e-3, differ.mean()


def test_rewards_done_and_state_vs_pallas(tiny_pair):
    *_, (jnew, jtraj), (new, traj) = tiny_pair
    # envs whose actions agreed at every step (a near-tie flip forks an env)
    same = (traj["action"].numpy() == np.asarray(jtraj["action"])).all(axis=(0, 2))
    assert same.mean() > 0.99
    np.testing.assert_array_equal(
        traj["reward"].numpy()[:, same], np.asarray(jtraj["reward"])[:, same]
    )
    np.testing.assert_array_equal(
        traj["done"].numpy()[:, same], np.asarray(jtraj["done"]).astype(bool)[:, same]
    )
    for f in ("agent_x", "agent_y", "agent_dir", "agent_carrying", "shelf_x", "shelf_y",
              "request_queue", "cur_steps"):
        np.testing.assert_array_equal(
            getattr(new, f).numpy()[same], np.asarray(getattr(jnew, f))[same], err_msg=f
        )


def test_recorded_actions_replay_through_jax_engine(tiny_pair):
    jenv, states, *_, (new, traj) = tiny_pair

    def replay(state, acts):
        def body(s, a):
            r = jenv._step_fn(s, a)
            return r.state, r.rewards

        return jax.lax.scan(body, state, acts)

    final, rews = jax.jit(jax.vmap(replay, in_axes=(0, 1), out_axes=(0, 1)))(
        states, jnp.asarray(traj["action"].numpy())
    )
    np.testing.assert_array_equal(new.agent_x.numpy(), np.asarray(final.agent_x))
    np.testing.assert_array_equal(new.agent_y.numpy(), np.asarray(final.agent_y))
    np.testing.assert_array_equal(traj["reward"].numpy(), np.asarray(rews))


def test_obs_bit_exact_sensor_range_2():
    *_, (jnew, jtraj), (new, traj) = _run_pair("rware-2s-tiny-2ag-v2", 4, 4)
    assert traj["obs"].shape[-1] == 183
    _assert_obs_equal_while_in_lockstep(traj, jtraj)


def test_random_mode_plain_trajectory():
    env = rware_tpu_torch.make("rware-small-4ag-v2", max_steps=10, device="cpu")
    states, obs0 = batched_reset(env, 0, 64)
    torch.manual_seed(0)
    policy = ActorCritic(env.config.flattened_obs_length)
    collect = build_fused_collect(env.config, 12)
    new, traj = collect(states, policy, 7)
    assert torch.equal(traj["obs"][0], obs0.to(torch.bfloat16))
    assert traj["done"][9].all() and not traj["done"][:9].any()
    assert bool(((traj["action"] >= 0) & (traj["action"] < 5)).all())
    assert bool((traj["logp"] <= 0).all()) and bool(torch.isfinite(traj["value"]).all())
    again = collect(states, policy, 7)[1]
    assert torch.equal(again["action"], traj["action"])  # the seed fixes the draws
    other = collect(states, policy, 8)[1]
    assert not torch.equal(other["action"], traj["action"])


def test_wrapper_checks_policy_and_shared_memory():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    states, _ = batched_reset(env, 0, 4)
    collect = build_fused_collect(env.config, 2)
    with pytest.raises(ValueError):
        collect(states, ActorCritic(env.config.flattened_obs_length, hidden=(64, 64)), 0)
    with pytest.raises(ValueError):
        build_fused_collect(env.config, 2, hidden=(128, 100))
    # hidden (128, 128) at sensor range 1: a tile of 64 envs (128 rows) on 256
    # threads, two blocks an SM
    assert (collect.plan.te, collect.plan.rows, collect.threads) == (64, 128, 256)
    assert collect.plan.smem < 232448 and collect.plan.blocks_per_sm == 2
