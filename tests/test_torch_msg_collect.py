"""The message mode of the fused collectors (K2b): the plain versions of the
MLP collector (K2a) and the recurrent collector (K2c) with ``msg_bits=2``
against the JAX package's ``build_pallas_collect(interpret=True,
deterministic=True)`` on the CPU, from the same env states (holding random
messages), numpy-seeded parameters with a message head and, for the GRU, a
nonzero carry; and the random mode's bit frequencies against ``sigmoid``
of the message logits.

Tolerances.  The two sides sum the heads in different orders, so a logit
moves by an ulp.  Deterministic mode takes the argmax move and the bits
``logit > 0``: a move changes only where two logits are closer than 2e-2
and a bit only where its logit is that close to 0; an env whose move or bit
changed sees other observations from then on.  So: observations exact in
every env and step before its first disagreement, rewards, done, bits and
the final state (messages included) exact in every env that always agreed
(at least 98% of them), values and joint log-probabilities within 2e-2
there (the bounds of ``tests/test_pallas_collect.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
import rware_tpu_torch
from rware_tpu.models import ActorCritic as FlaxActorCritic
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, build_pallas_collect
from rware_tpu_torch import convert
from rware_tpu_torch.models.networks import (
    gru_collect_step,
    gru_to_arrays,
    init_actor_critic,
    init_recurrent_actor_critic,
)
from rware_tpu_torch.ops.fused_rollout import (
    build_fused_collect,
    build_fused_collect_gru,
    build_fused_collect_per_agent,
)
from rware_tpu_torch.parallel import batched_reset
from tests.test_torch_gru import flax_params as gru_flax_params
from tests.torch_ref import jax_states, jit_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

M, T_LEN, EMBED, HG = 2, 8, 32, 32
ATOL = 2e-2


def _states(jenv, seed):
    """JAX reset states holding random messages (as after a step)."""
    jstates = jax_states(jenv, ENV_BLOCK, seed=seed)
    msg = np.random.default_rng(seed).integers(0, 2, (ENV_BLOCK, 2, M)).astype(np.float32)
    return jstates.replace(agent_message=jnp.asarray(msg))


def _with_message_head(params, hidden, seed):
    """``params`` with a numpy-seeded ``message`` Dense of M outputs, its
    bias off zero so that both bit values occur."""
    rng = np.random.default_rng(seed)
    p = dict(params["params"])
    p["message"] = {"kernel": (rng.standard_normal((hidden, M)) / np.sqrt(hidden))
                    .astype(np.float32),
                    "bias": (0.3 * rng.standard_normal(M)).astype(np.float32)}
    return {"params": p}


def _agreement(traj, jtraj):
    """(envs whose moves and bits always agreed, steps in lockstep (T, B))."""
    same = (traj["action"].numpy() == np.asarray(jtraj["action"])).all(-1) \
        & (traj["bits"].numpy() == np.asarray(jtraj["bits"])).all((-1, -2))
    lockstep = np.concatenate([np.ones_like(same[:1]), np.cumprod(same, 0)[:-1]], 0) > 0
    return same.all(0), lockstep


def _check_pair(pair):
    traj, jtraj, ns, jns = pair["traj"], pair["jtraj"], pair["ns"], pair["jns"]
    ok, lockstep = _agreement(traj, jtraj)
    assert ok.mean() >= 0.98, ok.mean()
    assert traj["bits"].shape == (T_LEN, ENV_BLOCK, 2, M) and traj["bits"].dtype == torch.int32
    assert 0.05 < float(traj["bits"].float().mean()) < 0.95  # both bit values occur
    np.testing.assert_array_equal(traj["obs"].float().numpy()[lockstep],
                                  np.asarray(jtraj["obs"], dtype=np.float32)[lockstep])
    for k in ("reward", "bits"):
        np.testing.assert_array_equal(traj[k].numpy()[:, ok], np.asarray(jtraj[k])[:, ok],
                                      err_msg=k)
    np.testing.assert_array_equal(traj["done"].numpy()[:, ok],
                                  np.asarray(jtraj["done"]).astype(bool)[:, ok])
    for k in ("value", "logp"):
        np.testing.assert_allclose(traj[k].numpy()[:, ok], np.asarray(jtraj[k])[:, ok],
                                   atol=ATOL, err_msg=k)
    got = convert.state_to_numpy(ns)
    for f in ("agent_x", "agent_y", "agent_dir", "agent_carrying", "shelf_x", "shelf_y",
              "request_queue", "cur_steps", "agent_message"):
        np.testing.assert_array_equal(got[f][ok], np.asarray(getattr(jns, f))[ok], err_msg=f)
    # the last step's bits are the new messages, cleared where the episode ended
    last = traj["bits"][-1].float() * (~traj["done"][-1]).float()[:, None, None]
    assert torch.equal(ns.agent_message, last)


@pytest.fixture(scope="module")
def mlp_pair():
    # episodes of 5 steps end inside the rollout: the messages are cleared
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", msg_bits=M, max_steps=5).config)
    jstates = _states(jenv, 3)
    model = FlaxActorCritic(n_actions=5, msg_bits=M)
    length = jenv.config.flattened_obs_length
    params = model.init(jax.random.key(1), jnp.zeros((1, 2, length)))
    params = _with_message_head(jax.tree.map(np.asarray, params), 128, 4)
    jcollect = build_pallas_collect(jenv.config, T_LEN, tc_len=4, interpret=True,
                                    deterministic=True)
    jns, jtraj = jit_bf16_exact(lambda s, p: jcollect(s, p, 0), jstates,
                                jax.tree.map(jnp.asarray, params))
    policy = convert.actor_critic_from_flax(params)
    collect = build_fused_collect(env.config, T_LEN, deterministic=True)
    ns, traj = collect(to_port(jstates), policy, 0)
    assert collect.launches == 0  # CPU tensors take the plain version
    return dict(jns=jns, jtraj=jtraj, ns=ns, traj=traj, policy=policy)


@pytest.fixture(scope="module")
def gru_pair():
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", msg_bits=M, max_steps=5).config)
    length = env.config.flattened_obs_length
    params = _with_message_head(gru_flax_params(7, obs_len=length, embed=EMBED, hidden=HG), HG, 5)
    jstates = _states(jenv, 6)
    rng = np.random.default_rng(11)
    h0 = np.array(jnp.asarray(rng.uniform(-1, 1, (ENV_BLOCK, 2, HG)), jnp.bfloat16)
                  .astype(jnp.float32))
    jcollect = build_pallas_collect(jenv.config, T_LEN, hidden=(EMBED, HG), tc_len=4,
                                    interpret=True, deterministic=True, policy="gru")
    jns, jh, jtraj = jit_bf16_exact(
        lambda s, p, h: jcollect(s, p, 0, h0=h), jstates, jax.tree.map(jnp.asarray, params),
        jnp.asarray(h0, jnp.bfloat16))
    policy = convert.recurrent_from_flax(params)
    assert policy.msg_bits == M
    collect = build_fused_collect_gru(env.config, T_LEN, (EMBED, HG), deterministic=True)
    ns, new_h, traj = collect(to_port(jstates), policy, 0, torch.from_numpy(h0).to(torch.bfloat16))
    assert collect.launches == 0
    return dict(jns=jns, jtraj=jtraj, ns=ns, traj=traj, new_h=new_h, jh=jh)


def test_mlp_collector_matches_pallas(mlp_pair):
    _check_pair(mlp_pair)


def test_gru_collector_matches_pallas(gru_pair):
    _check_pair(gru_pair)
    ok, _ = _agreement(gru_pair["traj"], gru_pair["jtraj"])
    np.testing.assert_allclose(gru_pair["new_h"].float().numpy()[ok],
                               np.asarray(gru_pair["jh"].astype(jnp.float32))[ok], atol=5e-2)


@pytest.mark.parametrize("net", ["mlp", "gru"])
def test_random_bits_follow_sigmoid(net):
    """Random mode: over 8 x 512 x 2 x 2 draws the bits' frequency matches
    the mean of ``sigmoid(logit)`` in each of five probability bins (within
    four standard errors), so ``u < sigmoid(l)`` is what is sampled; the
    seed fixes the draws."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", msg_bits=M, device="cpu")
    states, _ = batched_reset(env, 0, 512)
    length = env.config.flattened_obs_length
    if net == "mlp":
        policy = init_actor_critic(length, 5, (32, 32), 3, msg_bits=M)
        collect = build_fused_collect(env.config, 8, (32, 32))
        args = (states, policy, 7)
    else:
        policy = init_recurrent_actor_critic(length, 5, 16, 16, 3, msg_bits=M)
        collect = build_fused_collect_gru(env.config, 8, (16, 16))
        args = (states, policy, 7, policy.initialize_carry((512, 2)))
    with torch.no_grad():
        policy.message.weight.mul_(4.0)  # a spread of probabilities
        policy.message.bias.copy_(torch.tensor([-1.0, 1.0]))
        traj = collect(*args)[-1]
        if net == "mlp":
            logits = policy.heads(traj["obs"])[2]
        else:  # the collector's cell, step by step from the zero carry
            arrays, h, steps = gru_to_arrays(policy), torch.zeros((1024, 16)), []
            for t in range(8):
                (_, ml), _, h = gru_collect_step(arrays, h, traj["obs"][t].reshape(1024, -1), M)
                steps.append(ml.reshape(512, 2, M))
                h = torch.where(traj["done"][t].repeat_interleave(2)[:, None], 0.0, h)
            logits = torch.stack(steps)
    probs, bits = torch.sigmoid(logits), traj["bits"].float()
    edges = torch.linspace(0, 1, 6)
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (probs >= lo) & (probs < hi)
        n = int(sel.sum())
        if n < 200:
            continue
        p = float(probs[sel].mean())
        err = abs(float(bits[sel].mean()) - p)
        assert err < 4 * np.sqrt(p * (1 - p) / n) + 1e-3, (lo, hi, n, err)
    assert torch.equal(collect(*args)[-1]["bits"], traj["bits"])


def test_per_agent_collector_refuses_message_bits():
    """Both MLP collectors refuse networks without the env's message head
    (the per-agent one takes message bits since its message mode, K2d with
    K2b, is ported: ``tests/test_torch_seac_msg.py``)."""
    env = rware_tpu_torch.make("rware-tiny-2ag-v2", msg_bits=1, device="cpu")
    states, _ = batched_reset(env, 0, 4)
    length = env.config.flattened_obs_length
    with pytest.raises(ValueError, match="msg_bits=1"):
        build_fused_collect_per_agent(env.config, 4)(states, [init_actor_critic(length)] * 2, 0)
    collect = build_fused_collect(env.config, 2)
    with pytest.raises(ValueError, match="msg_bits=1"):
        collect(states, init_actor_critic(length), 0)
