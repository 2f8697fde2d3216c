"""The image mode (K2e) of the four fused collectors' plain versions against
the JAX package's ``build_pallas_collect(interpret=True, deterministic=True)``
on the CPU: K2a on IMAGE and IMAGE_DICT, directional and non-directional
(``-Nd``), and with two message bits (sampled and fed back, not observed);
K2c, K2d and K2d′ on IMAGE.  The same env states and numpy-seeded parameters
with nonzero biases (and, for the GRUs, a nonzero carry) go through both, at
B = ENV_BLOCK with episodes that end inside the rollout.

Tolerances, as ``tests/test_torch_fused_collect.py`` and
``tests/test_torch_gru_collect.py`` hold the FLATTENED modes: the two sides
sum the products in different orders, so a bf16 rounding flips now and then;
deterministic mode takes the argmax (and ``logit > 0`` for a bit), so an
action changes only where two logits are that close, and an env whose action
changed sees other observations from then on.  So: observations exact at
every step of every env that was in lockstep until then; rewards, ``done``,
bits and the final state exact in every env whose actions always agreed (at
least 98% of them, and 99% of the actions); values and log-probabilities
within 2e-2 there.  The CUDA kernels run only on a GPU
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 24).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
from rware_tpu.models import ActorCritic as FlaxActorCritic
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, build_pallas_collect
from rware_tpu_torch import convert
from rware_tpu_torch.models.networks import BlockDims, GruDims
from rware_tpu_torch.models.seac import seac_gru_policies_of, seac_policies_of
from rware_tpu_torch.ops.fused_rollout import (
    build_fused_collect,
    build_fused_collect_gru,
    build_fused_collect_gru_per_agent,
    build_fused_collect_per_agent,
)
from tests.test_torch_fused_seac import stacked_flax_params
from tests.test_torch_gru import flax_params as gru_flax_params
from tests.test_torch_msg_collect import _with_message_head
from tests.test_torch_seac_gru import stacked_gru_params
from tests.torch_ref import jax_states, jit_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

T_LEN, TC_LEN, HG, ATOL = 8, 4, 32, 2e-2
CASES = (
    ("mlp", "rware-img-tiny-2ag-v2", 0),
    ("mlp", "rware-imgdict-tiny-2ag-v2", 0),
    ("mlp", "rware-img-Nd-tiny-2ag-v2", 0),
    ("mlp", "rware-img-tiny-2ag-v2", 2),
    ("gru", "rware-img-tiny-2ag-v2", 0),
    ("mlp_per_agent", "rware-img-tiny-2ag-v2", 0),
    ("gru_per_agent", "rware-img-tiny-2ag-v2", 0),
)


def _run(policy_kind, env_id, m):
    # episodes of 5 steps end inside the rollout: resets, carry and message
    # clearing are exercised
    jenv, env = make_pair(rware_tpu.make(env_id, max_steps=5, msg_bits=m).config)
    n, length = env.n_agents, env.config.policy_obs_length
    jstates = jax_states(jenv, ENV_BLOCK, seed=3)
    recurrent = policy_kind.startswith("gru")
    hidden = (HG, HG) if recurrent else (128, 128)
    jcollect = build_pallas_collect(jenv.config, T_LEN, hidden=hidden, tc_len=TC_LEN,
                                    interpret=True, deterministic=True, policy=policy_kind)
    if policy_kind == "mlp":
        params = FlaxActorCritic(n_actions=5, msg_bits=m).init(
            jax.random.key(1), jnp.zeros((1, n, length)))
        params = jax.tree.map(np.asarray, params)
        if m:
            params = _with_message_head(params, 128, 4)
        policy = convert.actor_critic_from_flax(params)
        collect = build_fused_collect(env.config, T_LEN, deterministic=True)
    elif policy_kind == "mlp_per_agent":
        params = stacked_flax_params(3, n, length, hidden)
        policy = seac_policies_of(BlockDims(length, 128, 128, 5),
                                  convert.seac_params_from_flax(params))
        collect = build_fused_collect_per_agent(env.config, T_LEN, deterministic=True)
    elif policy_kind == "gru":
        params = gru_flax_params(7, obs_len=length, embed=HG, hidden=HG)
        policy = convert.recurrent_from_flax(params)
        collect = build_fused_collect_gru(env.config, T_LEN, hidden, deterministic=True)
    else:
        _, params = stacked_gru_params(11, 0, n=n, obs_len=length)
        policy = seac_gru_policies_of(GruDims(length, HG, HG, 5),
                                      convert.seac_params_from_flax(params))
        collect = build_fused_collect_gru_per_agent(env.config, T_LEN, hidden,
                                                    deterministic=True)
    jparams = jax.tree.map(jnp.asarray, params)
    if recurrent:
        rng = np.random.default_rng(12)
        h0 = np.array(jnp.asarray(rng.uniform(-1, 1, (ENV_BLOCK, n, HG)), jnp.bfloat16)
                      .astype(jnp.float32))
        jns, _, jtraj = jit_bf16_exact(lambda s, p, h: jcollect(s, p, 0, h0=h), jstates,
                                       jparams, jnp.asarray(h0, jnp.bfloat16))
        ns, _, traj = collect(to_port(jstates), policy, 0, torch.from_numpy(h0).to(torch.bfloat16))
    else:
        jns, jtraj = jit_bf16_exact(lambda s, p: jcollect(s, p, 0), jstates, jparams)
        ns, traj = collect(to_port(jstates), policy, 0)
    assert collect.launches == 0  # CPU tensors take the plain version
    return env, jns, jtraj, ns, traj


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}-M{c[2]}")
def collect_pair(request):
    return request.param, _run(*request.param)


def test_trajectory_layout(collect_pair):
    (_, _, m), (env, _, jtraj, _, traj) = collect_pair
    n, length = env.n_agents, env.config.policy_obs_length
    assert traj["obs"].dtype == torch.bfloat16
    assert tuple(traj["obs"].shape) == (T_LEN, ENV_BLOCK, n, length) == tuple(jtraj["obs"].shape)
    assert set(traj) == set(jtraj)
    if m:
        assert tuple(traj["bits"].shape) == (T_LEN, ENV_BLOCK, n, m)


def test_obs_exact_while_in_lockstep(collect_pair):
    (_, _, m), (env, _, jtraj, _, traj) = collect_pair
    same = (traj["action"].numpy() == np.asarray(jtraj["action"])).all(-1)  # (T, B)
    if m:
        same &= (traj["bits"].numpy() == np.asarray(jtraj["bits"])).all((-1, -2))
    lockstep = np.concatenate([np.ones_like(same[:1]), np.cumprod(same, 0)[:-1]], 0) > 0
    assert lockstep[-1].mean() > 0.98
    got = traj["obs"].float().numpy()
    np.testing.assert_array_equal(got[lockstep],
                                  np.asarray(jtraj["obs"], dtype=np.float32)[lockstep])
    assert set(np.unique(got)) <= {0.0, 1.0}  # the default layers are binary


def test_actions_rewards_done_and_state(collect_pair):
    (kind, _, m), (env, jns, jtraj, ns, traj) = collect_pair
    same = traj["action"].numpy() == np.asarray(jtraj["action"])
    if m:
        same &= (traj["bits"].numpy() == np.asarray(jtraj["bits"])).all(-1)
    ok = same.all(axis=(0, 2))
    assert same.mean() >= 0.99 and ok.mean() >= 0.98, (same.mean(), ok.mean())
    for k in ("reward",) + (("bits",) if m else ()):
        np.testing.assert_array_equal(traj[k].numpy()[:, ok], np.asarray(jtraj[k])[:, ok],
                                      err_msg=k)
    np.testing.assert_array_equal(traj["done"].numpy()[:, ok],
                                  np.asarray(jtraj["done"]).astype(bool)[:, ok])
    assert int(traj["done"].sum()) == ENV_BLOCK  # every env ended one episode at step 5
    got = convert.state_to_numpy(ns)
    for f in ("agent_x", "agent_y", "agent_dir", "agent_carrying", "shelf_x", "shelf_y",
              "request_queue", "cur_steps", "agent_message"):
        np.testing.assert_array_equal(got[f][ok], np.asarray(getattr(jns, f))[ok], err_msg=f)
    for k in ("value", "logp"):
        np.testing.assert_allclose(traj[k].numpy()[:, ok], np.asarray(jtraj[k])[:, ok],
                                   atol=ATOL, err_msg=k)
    if kind.endswith("per_agent"):  # the agents run different networks
        a = traj["action"].numpy()
        assert (a[..., 0] != a[..., 1]).mean() > 0.05


def test_wrappers_size_shared_memory_from_the_image_window():
    """The block size comes from ``policy_obs_length``: a 7x7 window (L=245)
    still fits a tile of 64 envs, an 11x11 one (L=605) fits no block of the MLP
    collector with the weights in shared memory, so that route raises and the
    plan reads them from device memory; an image config with no layer, or
    more than the kernel's table holds, is refused."""
    import dataclasses

    import rware_tpu_torch
    from rware_tpu_torch.ops.fused_rollout import SMEM_LIMIT, collect_plan

    cfg = rware_tpu_torch.parse_env_id("rware-img-3s-tiny-2ag-v2")
    collect = build_fused_collect(cfg, 2)
    assert collect.obs_len == cfg.policy_obs_length == 245 and collect.plan.te == 64
    assert collect.threads == 256 and collect.plan.smem <= SMEM_LIMIT
    per_agent = build_fused_collect_per_agent(rware_tpu_torch.parse_env_id(
        "rware-img-3s-small-4ag-v2"), 2)
    assert per_agent.weights_global  # four stacks at L=245 do not fit beside the tiles
    gru = build_fused_collect_gru(cfg, 2).plan(16384)
    assert (gru.te, gru.rows, gru.threads, gru.blocks_per_sm) == (64, 128, 256, 2)
    assert gru.smem <= SMEM_LIMIT
    img5 = rware_tpu_torch.parse_env_id("rware-img-5s-tiny-2ag-v2")
    with pytest.raises(ValueError, match="observation too long"):
        collect_plan(img5, (128, 128), weights_global=False)
    k2a = build_fused_collect(img5, 2)
    assert k2a.weights_global and k2a.plan.kx == 0 and k2a.plan.blocks_per_sm == 2
    assert build_fused_collect_gru(rware_tpu_torch.parse_env_id("rware-img-5s-tiny-2ag-v2"),
                                   2).obs_len == 605
    for layers in ((), tuple(range(7)) + (0,)):
        with pytest.raises(ValueError, match="image layers"):
            build_fused_collect(dataclasses.replace(cfg, image_observation_layers=layers), 2)
