"""Recurrent MAPPO as a whole, on the CPU: three chained updates of the
port's learner (K2c collect, with K2b at M=2; K6 values; per env band the
GRU actor's replay loss with ``vf_coef = 0`` through K9/K10 and the critic's
gradient from K5 ``with_actor=False`` on a band copy; the split optimizer)
against the JAX package's ``build_rnn_mappo_train_step(interpret=True,
deterministic_collect=True)`` at M=0 and M=2, 1,024 envs, T=8, E=1, M=2
minibatches (``tests/test_mappo.py:291-303``).  The loss-fused recurrent
IPPO update is held the same way in ``tests/test_torch_rnn_fused_loss_train.py``.

The JAX side runs its Pallas GRU kernels (``GRU_SEQ_IMPL =
"pallas_interpret"``: on the CPU its "auto" picks the XLA scan and would
skip them).  Both sides start from the same env states, parameters (biases
made nonzero) and optimizer state, with JAX's own epoch offsets handed over.
Two port runners follow each JAX one: the resynced runner's parameters and
optimizer state are set to JAX's before each update, the carried runner
keeps its own.

Tolerances as ``tests/test_torch_rnn_train.py``: parameters within 0.05 *
lr * P after P Adam steps, metrics within rtol 1e-2, the carry within 5e-2
and the env states equal in the envs whose deterministic actions agreed (at
least 95%).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rware_tpu
from rware_tpu.models import IPPOConfig as JaxConfig
from rware_tpu.models import ippo_rnn as jax_rnn
from rware_tpu.models import mappo as jax_mappo
from rware_tpu.models.networks import CentralCritic as FlaxCritic
from rware_tpu.models.networks import RecurrentActorCritic as FlaxRecurrent
from rware_tpu.ops.pallas_rollout import ENV_BLOCK, LANE
from rware_tpu_torch.convert import (
    gru_params_from_flax,
    mappo_opt_state_from_optax,
    mappo_params_from_flax,
)
from rware_tpu_torch import evaluate, train
from rware_tpu_torch.models import ippo, ippo_rnn, mappo
from rware_tpu_torch.models.networks import CriticDims, GruDims, RecurrentActorCritic
from tests.torch_ref import compile_bf16_exact, make_pair, to_port

torch.set_num_threads(1)

T_LEN, EMBED, HG, CRITIC = 8, 32, 32, (64, 64)
N_UPDATES, MAX_STEPS = 3, 12  # episodes end inside the 2nd and 3rd updates
PARTS = ("actor", "critic")


def jax_offsets(jrunner, epochs, rb):
    """The E row offsets the JAX update draws from its runner's key
    (``mappo.py:872, 928``, ``ippo_rnn.py:810, 870``)."""
    k_perm = jax.random.split(jrunner.key, 2)[1]
    return torch.tensor([int(jax.random.randint(k, (), 0, rb))
                         for k in jax.random.split(k_perm, epochs)])


def biased(params, seed):
    """``params`` with every bias moved off zero: a zero bias hides where it is rounded."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, params)


def assert_states_and_carry(runner, jrunner):
    """The env states equal, and the carries within 5e-2, in the envs whose
    deterministic actions (and bits) agreed so far (at least 95%)."""
    st, jst = runner.env_states, jrunner.env_states
    same = np.all(st.agent_x.numpy() == np.asarray(jst.agent_x), 1) \
        & np.all(st.agent_y.numpy() == np.asarray(jst.agent_y), 1) \
        & np.all(st.agent_message.numpy() == np.asarray(jst.agent_message), (1, 2))
    assert same.mean() >= 0.95, same.mean()
    assert runner.carry.dtype == torch.bfloat16
    np.testing.assert_allclose(runner.carry.float().numpy()[same],
                               np.asarray(jrunner.carry.astype(jnp.float32))[same], atol=5e-2)


def mappo_flat(jrunner):
    return mappo_params_from_flax(jax.tree.map(np.asarray, jrunner.params),
                                  actor_from_flax=gru_params_from_flax)


def mappo_port_runner(jrunner):
    return ippo_rnn.RNNRunnerState(
        params=mappo_flat(jrunner),
        opt_state=mappo_opt_state_from_optax(jax.tree.map(np.asarray, jrunner.opt_state),
                                             actor_from_flax=gru_params_from_flax),
        env_states=to_port(jrunner.env_states), obs=None,
        carry=torch.from_numpy(np.array(jrunner.carry.astype(jnp.float32))).to(torch.bfloat16),
        generator=torch.Generator(), update_idx=0, seed=0)


@pytest.fixture(scope="module", params=[0, 2], ids=["M=0", "M=2"])
def mappo_chain(request):
    m = request.param
    jenv, env = make_pair(rware_tpu.make("rware-tiny-2ag-v2", max_steps=MAX_STEPS,
                                         msg_bits=m).config)
    kw = dict(n_envs=ENV_BLOCK, rollout_len=T_LEN, epochs=1, minibatches=2)
    jcfg, cfg = JaxConfig(**kw), ippo.IPPOConfig(**kw)
    actor = FlaxRecurrent(n_actions=5, hidden=HG, embed=EMBED, msg_bits=m)
    critic = FlaxCritic(n_agents=2, hidden=CRITIC)
    jrunner, actor, critic, tx = jax_mappo.init_rnn_mappo_runner(jenv, jcfg, jax.random.key(1),
                                                                 actor, critic)
    params = biased(jrunner.params, 5)
    jrunner = jrunner.replace(params=params, opt_state=tx.init(params))
    l_obs = env.config.flattened_obs_length
    dims, cdims = GruDims(l_obs, EMBED, HG, 5, m), CriticDims(2, l_obs, *CRITIC)
    step = mappo.build_rnn_mappo_train_step(env, dims, cdims, cfg, deterministic_collect=True)
    synced = carried = mappo_port_runner(jrunner)
    history = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rnn, "GRU_SEQ_IMPL", "pallas_interpret")
        ts = compile_bf16_exact(
            jax_mappo.build_rnn_mappo_train_step(jenv, actor, critic, tx, jcfg, interpret=True,
                                                 deterministic_collect=True), jrunner)
        for u in range(N_UPDATES):
            offsets = jax_offsets(jrunner, cfg.epochs, ENV_BLOCK // LANE)
            fresh = mappo_port_runner(jrunner)
            synced = dataclasses.replace(synced, params=fresh.params, opt_state=fresh.opt_state)
            jrunner, jmetrics = ts(jrunner)
            synced, metrics = step(synced, offsets)
            carried, _ = step(carried, offsets)
            history.append((jrunner, jmetrics, synced, metrics, carried))
    return cfg, dims, history, step


def test_rnn_mappo_takes_its_kernels_and_crosses_episode_ends(mappo_chain):
    cfg, _, history, step = mappo_chain
    done = [int(h[3]["episodes_done"]) for h in history]
    assert done == [int(h[1]["episodes_done"]) for h in history]
    assert done[0] == 0 and min(done[1:]) == ENV_BLOCK, done
    assert step.critic_grads.t_mb == cfg.rollout_len and not step.critic_grads.with_actor
    counters = (step.collect, step.critic_values, step.gru_fwd, step.gru_bwd, step.critic_grads)
    assert all(c.launches == 0 for c in counters)  # CPU: the plain versions


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_resynced_rnn_mappo_update_matches_jax(mappo_chain, u):
    """From JAX's parameters and optimizer state: both parts within 0.05 * lr
    * P, counts and update index equal, metrics within rtol 1e-2, env states
    and carry in the agreeing envs."""
    cfg, dims, history, _ = mappo_chain
    jrunner, jmetrics, runner, metrics, _ = history[u]
    p = cfg.epochs * cfg.minibatches
    want = mappo_flat(jrunner)
    for part in PARTS:
        np.testing.assert_allclose(runner.params[part].numpy(), want[part].numpy(),
                                   atol=0.05 * cfg.lr * p, rtol=1e-3, err_msg=part)
        assert runner.opt_state[part].count == int(jrunner.opt_state[part][1][0].count)
    assert runner.update_idx == int(jrunner.update_idx) == u + 1
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-2, atol=1e-4, err_msg=k)
    assert_states_and_carry(runner, jrunner)
    # MAPPO's value term is the critic's: the actor's local value head takes none
    value_col = dims.split(runner.params["actor"] - history[0][2].params["actor"])[6][:, 5]
    assert float(value_col.abs().max()) == 0.0


@pytest.mark.parametrize("u", range(N_UPDATES))
def test_carried_rnn_mappo_update_tracks_jax(mappo_chain, u):
    """Each side carrying its own parameters and optimizer state: both parts
    within 0.05 * lr * P of JAX's after every update."""
    cfg, dims, history, _ = mappo_chain
    jrunner, _, _, _, carried = history[u]
    p = cfg.epochs * cfg.minibatches
    want = mappo_flat(jrunner)
    for part in PARTS:
        np.testing.assert_allclose(carried.params[part].numpy(), want[part].numpy(),
                                   atol=0.05 * cfg.lr * p, rtol=1e-3, err_msg=part)
        assert carried.opt_state[part].count == p * (u + 1)
    assert_states_and_carry(carried, jrunner)
    if dims.msg_bits and u:  # the message head learns
        message = dims.split(carried.params["actor"] - history[0][4].params["actor"])[6][:, 6:]
        assert float(message.abs().max()) > 0


@pytest.mark.parametrize("m", [0, 2])
def test_train_and_evaluate_rnn_mappo(tmp_path, m):
    """``train --algo mappo --net gru [--msg-bits 2]`` on the CPU, its policy
    file (the GRU actor and the critic) read back by ``evaluate``."""
    out = train.main(["--algo", "mappo", "--net", "gru", "--device", "cpu", "--n-envs", "128",
                      "--rollout-len", "8", "--updates", "1", "--msg-bits", str(m),
                      "--checkpoint-dir", str(tmp_path)])
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env"):
        assert np.isfinite(out[k]), k
    ckpt = torch.load(str(tmp_path / "policy.pt"))
    assert ckpt["net"] == "gru" and ckpt["msg_bits"] == m and "critic" in ckpt
    _, policy = train.load_policy(str(tmp_path / "policy.pt"))
    assert isinstance(policy, RecurrentActorCritic) and policy.msg_bits == m
    stats = evaluate.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path),
                           "--episodes", "4", "--max-steps", "20"])
    assert stats["episodes"] == 4 and np.isfinite(stats["mean_return"])
