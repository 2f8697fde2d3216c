"""The per-agent recurrent collector's plain version (K2d′, ``FusedCollectGru
PerAgent``) against the JAX package's ``build_pallas_collect(policy=
"gru_per_agent", interpret=True, deterministic=True)`` on the CPU, with and
without message bits (its K2b mode): the same env states, numpy-seeded
stacked parameters with nonzero biases and a nonzero carry go through both.
The CUDA kernel runs only on a GPU (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

Tolerances, as ``tests/test_torch_gru_collect.py`` holds K2c: the two sides
sum the cell's products in different orders, so a hidden unit's bf16 rounding
flips now and then and feeds back through the recurrence; deterministic mode
takes the argmax (and ``logit > 0`` for a bit), so an action or a bit changes
only where two logits (or a logit and 0) are closer than that noise, and an
env whose action changed sees other observations from then on.  So:
observations, rewards, ``done`` and bits exact and the final state equal in
every env whose actions and bits all agree, at least 99% of the actions (and
98% of the envs) agree, values and log-probs within 2e-2 and the new carry
within 5e-2 there, most of it to the bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, build_pallas_collect
from rware_tpu_torch import convert
from rware_tpu_torch.models.networks import GruDims, init_recurrent_actor_critic
from rware_tpu_torch.models.seac import seac_gru_policies_of
from rware_tpu_torch.ops.fused_rollout import (
    SMEM_LIMIT,
    build_fused_collect_gru,
    build_fused_collect_gru_per_agent,
    collect_gru_plan,
)
from rware_tpu_torch.parallel import batched_reset
from tests.test_torch_seac_gru import stacked_gru_params
from tests.torch_ref import jax_states, jit_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

T_LEN, TC_LEN, HG = 16, 8, 32
CASES = (("rware-tiny-2ag-v2", 0), ("rware-tiny-2ag-v2", 2), ("rware-small-4ag-v2", 0),
         ("rware-small-4ag-v2", 2))


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-M{c[1]}")
def collect_pair(request):
    env_id, m = request.param
    # episodes of 10 steps end inside the rollout: the carry resets are exercised
    jenv, env = make_pair(rware_tpu.make(env_id, max_steps=10, msg_bits=m).config)
    n, length = env.n_agents, env.config.flattened_obs_length
    _, params = stacked_gru_params(11, m, n=n, obs_len=length)
    jstates = jax_states(jenv, ENV_BLOCK, seed=3)
    rng = np.random.default_rng(12)
    h0 = np.array(jnp.asarray(rng.uniform(-1, 1, (ENV_BLOCK, n, HG)), jnp.bfloat16)
                  .astype(jnp.float32))
    jcollect = build_pallas_collect(jenv.config, T_LEN, hidden=(HG, HG), tc_len=TC_LEN,
                                    interpret=True, deterministic=True, policy="gru_per_agent")
    jns, jh, jtraj = jit_bf16_exact(
        lambda s, p, h: jcollect(s, p, 0, h0=h), jstates, jax.tree.map(jnp.asarray, params),
        jnp.asarray(h0, jnp.bfloat16))
    dims = GruDims(length, HG, HG, 5, m)
    policies = seac_gru_policies_of(dims, convert.seac_params_from_flax(params))
    collect = build_fused_collect_gru_per_agent(env.config, T_LEN, (HG, HG), deterministic=True)
    ns, new_h, traj = collect(to_port(jstates), policies, 0,
                              torch.from_numpy(h0).to(torch.bfloat16))
    same = traj["action"].numpy() == np.asarray(jtraj["action"])
    if m:
        same &= (traj["bits"].numpy() == np.asarray(jtraj["bits"])).all(-1)
    return dict(jns=jns, jh=jh, jtraj=jtraj, ns=ns, new_h=new_h, traj=traj, same=same,
                env_ok=same.all(axis=(0, 2)), collect=collect, m=m)


def test_actions_agree(collect_pair):
    assert collect_pair["collect"].launches == 0  # CPU tensors take the plain version
    assert collect_pair["same"].mean() >= 0.99
    assert collect_pair["env_ok"].mean() >= 0.98
    # the agents run different GRUs: their deterministic actions differ
    a = collect_pair["traj"]["action"].numpy()
    assert (a[..., 0] != a[..., 1]).mean() > 0.05


def test_trajectory_exact_where_actions_agree(collect_pair):
    ok, traj, jtraj = collect_pair["env_ok"], collect_pair["traj"], collect_pair["jtraj"]
    np.testing.assert_array_equal(traj["obs"].float().numpy()[:, ok],
                                  np.asarray(jtraj["obs"], dtype=np.float32)[:, ok])
    np.testing.assert_array_equal(traj["reward"].numpy()[:, ok], np.asarray(jtraj["reward"])[:, ok])
    np.testing.assert_array_equal(traj["done"].numpy()[:, ok],
                                  np.asarray(jtraj["done"]).astype(bool)[:, ok])
    if collect_pair["m"]:
        np.testing.assert_array_equal(traj["bits"].numpy()[:, ok],
                                      np.asarray(jtraj["bits"])[:, ok])
        share = traj["bits"].float().mean()
        assert 0.05 < share < 0.95, share
    else:
        assert "bits" not in traj
    assert int(traj["done"].sum()) == ENV_BLOCK  # every env ended one episode


def test_final_state_equal_where_actions_agree(collect_pair):
    ok = collect_pair["env_ok"]
    got = convert.state_to_numpy(collect_pair["ns"])
    for f in ("agent_x", "agent_y", "agent_dir", "agent_carrying", "shelf_x", "shelf_y",
              "cur_steps", "request_queue", "agent_message"):
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
    assert collect_pair["new_h"].dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got[ok], want[ok], atol=5e-2)
    assert (np.abs(got - want)[ok] > 0).mean() < 0.05  # most entries equal to the bit
    assert np.abs(got).max() > 0  # restarted at step 10 and ran 6 steps


def test_per_agent_equals_shared_collector_when_agents_share():
    """N copies of one GRU give K2c's trajectory and carry, draw for draw,
    with message bits too."""
    env = rware_tpu_torch.make("rware-small-4ag-v2", max_steps=7, msg_bits=1, device="cpu")
    states, _ = batched_reset(env, 0, 32)
    policy = init_recurrent_actor_critic(env.config.flattened_obs_length, 5, 16, 16, 3, 1)
    h0 = (torch.rand((32, 4, 16), generator=torch.Generator().manual_seed(0)) - 0.5) \
        .to(torch.bfloat16)
    want = build_fused_collect_gru(env.config, 12, (16, 16))(states, policy, 7, h0)
    got = build_fused_collect_gru_per_agent(env.config, 12, (16, 16))(states, [policy] * 4, 7, h0)
    assert torch.equal(got[1], want[1])
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k
    assert int(got[2]["done"].sum()) == 32


def test_per_agent_collector_checks_and_routes():
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cpu")
    states, _ = batched_reset(env, 0, 4)
    length = env.config.flattened_obs_length
    collect = build_fused_collect_gru_per_agent(env.config, 2, (16, 16))
    h0 = torch.zeros((4, 2, 16), dtype=torch.bfloat16)
    net = init_recurrent_actor_critic(length, 5, 16, 16)
    with pytest.raises(ValueError, match="one per agent"):
        collect(states, [net], 0, h0)
    with pytest.raises(ValueError, match="one per agent"):
        collect(states, [net, init_recurrent_actor_critic(length, 5, 16, 16, msg_bits=1)], 0, h0)
    with pytest.raises(ValueError, match="h0 must be bf16"):
        collect(states, [net, net], 0, h0.float())
    # the agents' bias and head blocks sit in shared memory where they cost
    # the tile no block an SM (two agents without eight message bits), else
    # they are read from device memory (eight and sixteen at embed and GRU
    # width 128); every registered config keeps two blocks of 256 threads an
    # SM at B=16,384
    for env_id in ("rware-tiny-2ag-v2", "rware-large-8ag-v2", "rware-tiny-16ag-v2"):
        for m in (0, 8):
            cfg = dataclasses.replace(rware_tpu_torch.parse_env_id(env_id), msg_bits=m)
            big = build_fused_collect_gru_per_agent(cfg, 2)
            plan = big.plan(16384)
            assert big.n_stacks == cfg.n_agents and plan.te % 8 == 0, (env_id, m)
            assert plan.heads_global == (cfg.n_agents > 2 or m == 8), (env_id, m)
            assert (plan.threads, plan.blocks_per_sm) == (256, 2), (env_id, m)
            assert plan.smem <= SMEM_LIMIT
    # sixteen stacks with eight message bits do not fit beside the smallest
    # per-agent tile (8 envs, 128 rows), so they are read from device memory;
    # without message bits they fit, at one block an SM
    cfg = dataclasses.replace(rware_tpu_torch.parse_env_id("rware-tiny-16ag-v2"), msg_bits=8)
    with pytest.raises(ValueError, match="observation too long"):
        collect_gru_plan(cfg, (128, 128), 16, heads_global=False)
    forced = collect_gru_plan(dataclasses.replace(cfg, msg_bits=0), (128, 128), 16,
                              heads_global=False)
    assert not forced.heads_global and forced.blocks_per_sm == 1
    cfg = rware_tpu_torch.parse_env_id("rware-tiny-2ag-v2")
    assert build_fused_collect_gru(cfg, 2).plan(16384) == collect_gru_plan(cfg, (128, 128))
