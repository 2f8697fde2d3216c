"""The recurrent collector's plain version (K2c) against the JAX package's
``build_pallas_collect(policy="gru", interpret=True, deterministic=True)``
on the CPU: the same env states, numpy-seeded parameters with nonzero biases
and a nonzero carry go through both.

Tolerances.  The two sides sum the cell's products in different orders, so a
hidden unit's bf16 rounding flips now and then; the flip feeds back through
the recurrence.  Deterministic mode takes the argmax, so an action changes
only where two logits are closer than that noise; an env whose action
changed sees other observations from then on.  So: observations, rewards and
``done`` exact and the final state equal in every env whose actions all
agree, at least 99% of the actions (and 98% of the envs) agree, values within
2e-2 and the new carry within 5e-2 there (the bounds of
``tests/test_pallas_collect.py:430-434``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, build_pallas_collect
from rware_tpu_torch import convert
from rware_tpu_torch.ops.fused_rollout import build_fused_collect_gru
from tests.test_torch_gru import flax_params
from tests.torch_ref import jax_states, jit_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

T_LEN, EMBED, HG = 8, 32, 32


@pytest.fixture(scope="module")
def collect_pair():
    # episodes of 5 steps end inside the rollout: the carry resets are exercised
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=5).config)
    length = env.config.flattened_obs_length
    params = flax_params(7, obs_len=length, embed=EMBED, hidden=HG)
    jstates = jax_states(jenv, ENV_BLOCK, seed=3)
    rng = np.random.default_rng(11)
    h0 = np.array(jnp.asarray(rng.uniform(-1, 1, (ENV_BLOCK, 2, HG)), jnp.bfloat16)
                  .astype(jnp.float32))
    jcollect = build_pallas_collect(jenv.config, T_LEN, hidden=(EMBED, HG), tc_len=4,
                                    interpret=True, deterministic=True, policy="gru")
    jns, jh, jtraj = jit_bf16_exact(
        lambda s, p, h: jcollect(s, p, 0, h0=h), jstates, jax.tree.map(jnp.asarray, params),
        jnp.asarray(h0, jnp.bfloat16))
    policy = convert.recurrent_from_flax(params)
    collect = build_fused_collect_gru(env.config, T_LEN, (EMBED, HG), deterministic=True)
    ns, new_h, traj = collect(to_port(jstates), policy, 0, torch.from_numpy(h0).to(torch.bfloat16))
    same = (traj["action"].numpy() == np.asarray(jtraj["action"]))
    return dict(jns=jns, jh=jh, jtraj=jtraj, ns=ns, new_h=new_h, traj=traj, same=same,
                env_ok=same.all(axis=(0, 2)), collect=collect)


def test_actions_agree(collect_pair):
    assert collect_pair["same"].mean() >= 0.99
    assert collect_pair["env_ok"].mean() >= 0.98


def test_trajectory_exact_where_actions_agree(collect_pair):
    ok, traj, jtraj = collect_pair["env_ok"], collect_pair["traj"], collect_pair["jtraj"]
    np.testing.assert_array_equal(traj["obs"].float().numpy()[:, ok],
                                  np.asarray(jtraj["obs"], dtype=np.float32)[:, ok])
    np.testing.assert_array_equal(traj["reward"].numpy()[:, ok], np.asarray(jtraj["reward"])[:, ok])
    np.testing.assert_array_equal(traj["done"].numpy()[:, ok],
                                  np.asarray(jtraj["done"]).astype(bool)[:, ok])
    assert int(traj["done"].sum()) == ENV_BLOCK  # every env ended one episode


def test_final_state_equal_where_actions_agree(collect_pair):
    ok = collect_pair["env_ok"]
    got = convert.state_to_numpy(collect_pair["ns"])
    for f in ("agent_x", "agent_y", "agent_dir", "agent_carrying", "shelf_x", "shelf_y",
              "cur_steps", "request_queue"):
        np.testing.assert_array_equal(got[f][ok], np.asarray(getattr(collect_pair["jns"], f))[ok],
                                      err_msg=f)


def test_values_and_logp_close(collect_pair):
    ok, traj, jtraj = collect_pair["env_ok"], collect_pair["traj"], collect_pair["jtraj"]
    for k in ("value", "logp"):
        np.testing.assert_allclose(traj[k].numpy()[:, ok], np.asarray(jtraj[k])[:, ok], atol=2e-2,
                                   err_msg=k)


def test_new_carry_close_and_reset(collect_pair):
    ok = collect_pair["env_ok"]
    got = collect_pair["new_h"].float().numpy()
    want = np.asarray(collect_pair["jh"].astype(jnp.float32))
    assert collect_pair["new_h"].dtype == torch.bfloat16 and got.shape == (ENV_BLOCK, 2, HG)
    np.testing.assert_allclose(got[ok], want[ok], atol=5e-2)
    assert (np.abs(got - want)[ok] > 0).mean() < 0.05  # most entries equal to the bit
    # T=8 with episodes of 5: the carry restarted at step 5 and ran 3 steps
    assert np.abs(got).max() > 0


def test_carry_is_zero_after_an_episode_end():
    _, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=4).config)
    length = env.config.flattened_obs_length
    policy = convert.recurrent_from_flax(flax_params(8, obs_len=length, embed=16, hidden=16))
    from rware_tpu_torch.parallel import batched_reset

    states, _ = batched_reset(env, 0, 32)
    collect = build_fused_collect_gru(env.config, 8, (16, 16))
    h0 = torch.ones((32, 2, 16), dtype=torch.bfloat16)
    _, new_h, traj = collect(states, policy, 5, h0)
    assert bool(traj["done"][-1].all()) and float(new_h.float().abs().max()) == 0.0
    assert collect.launches == 0  # CPU tensors: the plain version
    # one step fewer: the carry is live, and differs from a zero-carry start
    collect7 = build_fused_collect_gru(env.config, 7, (16, 16))
    _, h_a, _ = collect7(states, policy, 5, h0)
    _, h_b, _ = collect7(states, policy, 5, torch.zeros_like(h0))
    assert float(h_a.float().abs().max()) > 0
    assert torch.equal(h_a, h_b)  # both restarted at step 4


def test_collector_checks_its_arguments():
    _, env = make_pair("rware-tiny-2ag-v2")
    length = env.config.flattened_obs_length
    policy = convert.recurrent_from_flax(flax_params(9, obs_len=length, embed=16, hidden=16))
    from rware_tpu_torch.parallel import batched_reset

    states, _ = batched_reset(env, 0, 4)
    collect = build_fused_collect_gru(env.config, 2, (16, 16))
    with pytest.raises(ValueError, match="h0 must be bf16"):
        collect(states, policy, 0, torch.zeros((4, 2, 16)))
    with pytest.raises(ValueError, match="policy must be"):
        build_fused_collect_gru(env.config, 2, (16, 32))(
            states, policy, 0, torch.zeros((4, 2, 32), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiples of 8"):
        build_fused_collect_gru(env.config, 2, (12, 16))
